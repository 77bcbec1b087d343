"""The parallel layer. Only replica failover (:mod:`.replicas`) is ported;
meshes, sharding and placement come with ROADMAP A.8."""
