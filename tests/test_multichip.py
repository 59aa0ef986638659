"""Multi-device sharded training tests on the virtual 8-device CPU mesh.

Analog of the reference's `mpirun -n N` on one box exercising learner-rank
topologies (SURVEY.md section 4.5, --nLearners K).
"""
import jax
import numpy as np
import pytest

from smarties_tpu.envs import cartpole
from smarties_tpu.parallel.mesh import make_mesh
from smarties_tpu.runtime.trainer import Trainer
from smarties_tpu.utils.config import HyperParameters


def small_cfg(**kw):
    d = dict(minTotObsNum=512, maxTotObsNum=2048, batchSize=32,
             obsPerStep=1.0, nnLayerSizes=[32, 32])
    d.update(kw)
    return HyperParameters(**d)


class TestSharded:
    def test_8dev_train_runs(self):
        mesh = make_mesh(8)
        tr = Trainer(cartpole, cartpole.MDP, small_cfg(), n_envs=16,
                     n_slots=64, max_len=64, mesh=mesh)
        tr.warmup(chunk=16)
        tr.train(50, log_every=10**9)
        assert tr.n_grad_steps >= 50
        assert np.isfinite(float(tr.replay.beta))
        # params identical across devices (replicated after psum'd grads)
        w = tr.params["out"]["W"]
        assert np.isfinite(np.asarray(w)).all()

    def test_grad_parity_1dev_vs_4dev_exact(self):
        """EXACT cross-layout gradient parity: the same global batch of
        pinned (episode, t) samples, split across 4 shards whose replay
        shards hold the owning episodes, must produce the SAME updated
        parameters as one device holding everything (the psum of
        shard-local gradient sums equals the single-device batch sum —
        the reference's MPI_Iallreduce semantics, Optimizer.cpp:110-119,
        HyperParameters::defineDistributedLearning)."""
        from smarties_tpu.utils.harness import grad_parity
        p1, p4 = grad_parity(4)
        for a, b in zip(p1, p4):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


class TestRebalance:
    def test_ring_rebalance_fills_empty_shard(self):
        """Cross-shard episode balancing (DataCoordinator.cpp:91-112
        round-robin analog): an empty shard next to a loaded one receives
        episodes at the refresh cadence."""
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from smarties_tpu.parallel.mesh import AXIS, replay_pspec
        from smarties_tpu.replay import buffer as rb

        K, n_slots, max_len = 4, 32, 16
        rs = rb.init_replay(n_slots, max_len, 3, 1, 2, 4.0)
        # shard 0 (slots 0..7) fully loaded; all other shards empty
        loaded = jnp.arange(n_slots) < 8
        rs = rs._replace(
            ep_id=jnp.where(loaded, jnp.arange(n_slots), -1).astype(
                jnp.int32),
            length=jnp.where(loaded, 10, 0).astype(jnp.int32),
            rho=jnp.ones_like(rs.rho))
        mesh = make_mesh(K)
        rs_sp = replay_pspec(rs)
        f = jax.jit(shard_map(
            lambda r: rb.rebalance_shards(r, AXIS, k_max=4,
                                          max_tot_obs=10**6),
            mesh=mesh, in_specs=(rs_sp,), out_specs=rs_sp,
            check_vma=False))
        counts = lambda r: [int((np.asarray(r.ep_id).reshape(K, -1)[k]
                                 >= 0).sum()) for k in range(K)]
        assert counts(rs) == [8, 0, 0, 0]
        for _ in range(3):   # repeated refreshes even the ring out
            rs = f(rs)
        c = counts(rs)
        assert sum(c) == 8, c                 # nothing lost or duplicated
        assert c[0] < 8 and c[1] > 0, c      # neighbor received episodes
        # total stored steps preserved
        assert int(np.asarray(rs.length).sum()) == 80


class TestGraftEntry:
    def test_entry(self):
        import __graft_entry__ as g
        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[0] == 256

    def test_dryrun(self):
        import __graft_entry__ as g
        g.dryrun_multichip(8)
