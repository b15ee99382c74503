"""Multi-chip execution over a jax.sharding.Mesh.

This layer is NEW relative to the reference (SURVEY.md §2.2 "Distributed
communication backend: None") — the reference scales only by morsel-driven
threads in one process (src/parallel/task_scheduler.cpp). Here, tables
shard across the devices of a mesh (GPUs of one host) and queries run
SPMD:

- segment-parallel scans/aggregates: segments sharded over the mesh,
  partial states merged with psum (the morsel-parallelism analogue)
- hash repartitioning via all_to_all for joins/group-bys whose keys are
  not co-partitioned (the exchange operator DuckDB lacks)
- small build sides broadcast to every device

Collectives (psum/all_to_all/all_gather inside shard_map) are lowered by
XLA, to NCCL over NVLink on GPUs; tests exercise an 8-device virtual CPU
mesh."""
