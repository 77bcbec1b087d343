"""Static analysis of the port's pipelines. Only the byte estimators that
placement needs (:mod:`.costmodel`) are ported; the lint, the chain
analyzer and the rest of the cost model come with ROADMAP A.9."""
