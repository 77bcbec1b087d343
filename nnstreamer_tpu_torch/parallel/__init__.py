"""The parallel layer: device meshes and their shardings (:mod:`.mesh`), a
filter's model over a mesh (:mod:`.sharded_model`), replica failover
(:mod:`.replicas`), and training and sequence parallelism: ring attention
(:mod:`.ring_attention`), Ulysses (:mod:`.ulysses`), expert-parallel MoE
(:mod:`.moe`), the GPipe pipeline (:mod:`.pipeline_parallel`), the
dp × sp × ep LM step (:mod:`.lm`), MobileNet-v2's dp × tp step
(:mod:`.train`) over the placing helpers of :mod:`.spmd`, checkpoints
(:mod:`.checkpoint`) and the multi-process runtime (:mod:`.multihost`)."""
