"""The parallel layer: device meshes and their shardings (:mod:`.mesh`), a
filter's model over a mesh (:mod:`.sharded_model`) and replica failover
(:mod:`.replicas`). Training and sequence parallelism (ring attention,
Ulysses, MoE, pipeline parallelism, multihost) come with ROADMAP A.8b."""
