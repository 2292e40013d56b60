"""The sharded paths of the port on `torch.distributed`: `srsran_ce_tpu/parallel/`.

  mesh           process groups, meshes (`make_mesh`), batch slices, the
                 barrier and the heartbeat;
  comm           the collective layer: psum, all_gather, halo exchange;
  data_parallel  the DP estimator, receiver and decoder (no collective);
  subcarrier     the subcarrier-sharded estimator, receiver and tracker;
  launch         `spawn_world`: a world of ranks on one machine.

SPMD: one process a rank, each with its own blocks of the inputs and outputs.
"""
