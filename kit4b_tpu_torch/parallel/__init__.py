"""Multi-device strategies of the port: port of kit4b_tpu/parallel.

JAX runs each of these as one single-controller program over a device
mesh (`shard_map`). The port keeps that shape: one process drives a list
of torch devices, and each shard's work runs on its device in a loop.
`[torch.device("cuda:0")] * D` runs every shard on one card, a list of
distinct cards spreads them, and `[torch.device("cpu")] * D` runs them in
the calling process, as the tests do. `torch.distributed` appears only in
`distributed.py`, where JAX uses `jax.distributed`.

- `mesh`: the dp x tp mesh, the key- and position-sharded index builders
  and the sharded kalign passes (SE v3/v4/v5, SE, PE and deep PE by
  position);
- `hammings_mesh` and `hammings_ring`: `hammings -M` and `-R` as shards
  of the node engine (`kmer/hammings_mxu.py` `HammingsNode`);
- `swservice`: batched SW scoring over a list of devices;
- `distributed`: process groups and per-process input and output shards.
"""
