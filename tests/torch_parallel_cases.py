"""The JAX package's side of `kit4b_tpu_torch/tools/make_parallel_golden.py`
(`jax_fns()`: its parallel paths on `jax.devices()[:D]` of the 8-device
virtual CPU mesh, the XLA branch as its own tests take it), shared by the
tests of the port's parallel package and the golden's script. pytest does
not collect this file."""
from types import SimpleNamespace

import numpy as np

from kit4b_tpu_torch.tools import make_parallel_golden as mg


def jax_fns() -> SimpleNamespace:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kit4b_tpu.ops.extend_packed import pack_genome
    from kit4b_tpu.ops.seed_extend_fast import make_gview_device
    from kit4b_tpu.parallel import mesh as jm
    from kit4b_tpu.parallel.hammings_mesh import hammings_mesh
    from kit4b_tpu.parallel.hammings_ring import hammings_ring
    from kit4b_tpu.parallel.swservice import SWJob, SWService
    from kit4b_tpu.pacbio.sswd import SWScores

    L = mg.READ_LEN

    def gview(index):
        gpack, gbad = pack_genome(index.genome.seq, 65)
        return make_gview_device(gpack, gbad, (L + 15) // 16 + 1)

    def as_np(res):
        return {k: np.asarray(v) for k, v in res.items()}

    def key_pass(ver, dp, tp, index, reads, kw):
        m = jm.make_mesh(dp, tp)
        gv = gview(index)
        if ver == "v5":
            _, l4, klo = jm.shard_index_by_key_v5(index.sa_clean, index.lut,
                                                  tp)
            args = jm.device_put_sharded_index_v5(m, gv, l4, klo)
            fn = jm.make_sharded_align_pass_v5(m, read_len=L, **kw)
        else:
            args = jm.device_put_sharded_index_v3(
                m, gv, *jm.shard_index_by_key_v3(index.sa_clean, index.lut,
                                                 tp))
            if ver == "v3":
                return as_np(jm.make_sharded_align_pass_v3(m, **kw)(
                    *args, np.asarray(reads)))
            fn = jm.make_sharded_align_pass_v4(m, read_len=L, **kw)
        return as_np(fn(*args, *jm.pack_reads_sharded(reads, dp)))

    def pos_index(m, index, tp):
        gvb, base, sa_s, lut2_s = jm.shard_index_by_position(index, tp, L)
        return (jax.device_put(jnp.asarray(gvb),
                               NamedSharding(m, P("tp", None, None))),
                jax.device_put(jnp.asarray(base), NamedSharding(m, P("tp"))),
                jax.device_put(jnp.asarray(sa_s),
                               NamedSharding(m, P("tp", None))),
                jax.device_put(jnp.asarray(lut2_s),
                               NamedSharding(m, P("tp", None, None))))

    def pos_pass(dp, tp, index, reads, kw):
        m = jm.make_mesh(dp, tp)
        fn = jm.make_sharded_align_pass_pos(m, read_len=L, **kw)
        return as_np(fn(*pos_index(m, index, tp),
                        *jm.pack_reads_sharded(reads, dp)))

    def pe(make, dp, tp, index, r1, r2, kw):
        m = jm.make_mesh(dp, tp)
        fn = make(m, read_len=L, **kw)
        return np.asarray(fn(*pos_index(m, index, tp),
                             np.asarray(index.genome.starts, np.int32),
                             *jm.pack_reads_sharded(r1, dp),
                             *jm.pack_reads_sharded(r2, dp)))

    def hammings(engine, codes, K, antisense, D, T, S, node, numnodes):
        devs = jax.devices()[:D]
        if engine == "ring":
            return hammings_ring(codes, K, antisense=antisense, devices=devs,
                                 T=T, S=S, use_pallas=False)
        return hammings_mesh(codes, K, antisense=antisense, devices=devs,
                             node=node, numnodes=numnodes, T=T, S=S,
                             use_pallas=False)

    def jobs_of(jobs):
        return [SWJob(p, t, d0) for p, t, d0 in jobs]

    def sw_score(jobs, band, D):
        return SWService(band=band, scores=SWScores(),
                         devices=jax.devices()[:D]).score(jobs_of(jobs))

    def sw_align(jobs, band):
        return SWService(band=band, scores=SWScores(),
                         devices=jax.devices()[:1]).align(jobs_of(jobs))

    return SimpleNamespace(
        key_pass=key_pass, pos_pass=pos_pass,
        pe_pass=lambda *a: pe(jm.make_sharded_pe_pass_pos, *a),
        deep_pass=lambda *a: pe(jm.make_sharded_deep_pe_pass_pos, *a),
        hammings=hammings, sw_score=sw_score, sw_align=sw_align)
