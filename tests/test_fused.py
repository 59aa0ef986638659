"""Fused steady-state cycle: mechanics + learning parity.

The fused program (Trainer.train_fused) must keep the obsPerStep pacing
invariant and learn equivalently to the chunked loop.
"""
import numpy as np
import pytest

from smarties_tpu.envs import cartpole
from smarties_tpu.runtime.trainer import Trainer
from smarties_tpu.utils.config import HyperParameters


class TestFusedCycle:
    def test_pacing_invariant(self):
        cfg = HyperParameters(minTotObsNum=512, maxTotObsNum=2048,
                              batchSize=32, nnLayerSizes=[32],
                              obsPerStep=1.0)
        tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=16, n_slots=64,
                     max_len=128)
        tr.warmup(chunk=16)
        g0 = tr.n_grad_steps
        backlog0 = (tr.n_env_steps - tr.n_obs_b4_start) - g0
        tr.train_fused(160 + backlog0, log_every=10**9)
        # cycles add n_envs obs per n_envs grads; the residual mismatch is
        # bounded by the initial warmup backlog + one cycle
        assert tr.n_grad_steps >= g0 + 160
        n_loc = tr.n_env_steps - tr.n_obs_b4_start
        assert abs(n_loc - tr.n_grad_steps) <= tr.n_envs + backlog0, \
            (n_loc, tr.n_grad_steps, backlog0)
        # the pacing inequality itself always holds
        assert n_loc >= tr.n_grad_steps * tr.cfg.obsPerStep - tr.n_envs

    def test_blind_warmup_and_deferred_flush(self):
        """Transfer-free bench path: warmup(blind_sweeps=) must fill the
        buffer without reading device counters back, and
        train_fused(flush=False) must leave episode logs pending on
        device (no device->host transfer inside a timed region)."""
        cfg = HyperParameters(minTotObsNum=512, maxTotObsNum=2048,
                              batchSize=32, nnLayerSizes=[32],
                              obsPerStep=1.0)
        tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=16, n_slots=64,
                     max_len=128)
        tr.log_flush_threshold = 10 ** 9
        tr.warmup(chunk=16, blind_sweeps=512 // 16)
        assert tr._initialized
        # 512 env steps ran; committed = completed episodes only (the
        # in-flight remainder matches the reference's startup transient)
        stored = int(tr.replay.n_stored_steps())
        assert 0 < stored <= 512, stored
        tr.train_fused(64, log_every=10 ** 9, flush=False)
        assert len(tr._pending_logs) > 0   # logs still on device
        tr._flush_logs()                   # explicit transfer at the end
        assert not tr._pending_logs
        assert tr.n_grad_steps >= 64

    @pytest.mark.slow
    def test_fused_learns(self):
        cfg = HyperParameters(minTotObsNum=2048, maxTotObsNum=16384,
                              batchSize=128, randSeed=7)
        tr = Trainer(cartpole.discrete, cartpole.discrete.MDP, cfg,
                     n_envs=32, n_slots=512, max_len=500)
        tr.warmup(chunk=32)
        tr.train_fused(4000, log_every=10**9)
        ev = np.mean(tr.evaluate(8))
        assert ev > 150, ev  # measured ~479 at this budget
