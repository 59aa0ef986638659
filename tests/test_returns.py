"""Retrace/GAE scans vs a direct python port of the reference recursion.

Reference recursions: MemoryProcessing.cpp:391-416 (computeRetrace,
computeRetraceExplBonus, computeGAE) applied backward by
updateReturnEstimator (:23-44).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smarties_tpu.ops.returns import (batched_return_estimate,
                                      episode_return_estimate)
from smarties_tpu.utils.harness import reference_return_estimate


def reference_recursion(r, V, A, rho, T, terminal, gamma, lam, mode="retrace",
                        baseline=0.0):
    """The float64 reference recursion on one episode."""
    return reference_return_estimate(
        *(np.asarray(x)[None] for x in (r, V, A, rho)), [T], [terminal],
        gamma, lam, mode, err_baseline=baseline)[0]


def make_episode(L, T, terminal, seed=0):
    rng = np.random.RandomState(seed)
    r = np.zeros(L + 1)
    r[1:T + 1] = rng.randn(T)
    V = np.zeros(L + 1)
    V[:T + 1] = rng.randn(T + 1)
    if terminal:
        V[T] = 0.0
    A = np.zeros(L + 1)
    A[:T] = rng.randn(T)
    rho = np.zeros(L + 1)
    rho[:T] = np.exp(rng.randn(T))
    return r, V, A, rho


class TestRetrace:
    def test_matches_reference(self):
        L, T = 16, 11
        for terminal in (True, False):
            for mode in ("retrace", "GAE", "retraceExplore"):
                r, V, A, rho = make_episode(L, T, terminal)
                want = reference_recursion(r, V, A, rho, T, terminal,
                                           0.995, 0.95, mode, baseline=0.3)
                got = episode_return_estimate(
                    jnp.asarray(r, jnp.float32), jnp.asarray(V, jnp.float32),
                    jnp.asarray(A, jnp.float32), jnp.asarray(rho, jnp.float32),
                    jnp.asarray(T, jnp.int32), jnp.asarray(terminal),
                    0.995, 0.95, mode, err_baseline=0.3)
                np.testing.assert_allclose(got[:T + 1], want[:T + 1],
                                           rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(got[T + 1:], 0.0)

    def test_batched(self):
        L = 20
        eps = [make_episode(L, T, term, seed=T)
               for T, term in [(5, True), (20, False), (1, True), (13, False)]]
        lengths = np.asarray([5, 20, 1, 13], np.int32)
        terms = np.asarray([True, False, True, False])
        r = jnp.asarray(np.stack([e[0] for e in eps]), jnp.float32)
        V = jnp.asarray(np.stack([e[1] for e in eps]), jnp.float32)
        A = jnp.asarray(np.stack([e[2] for e in eps]), jnp.float32)
        rho = jnp.asarray(np.stack([e[3] for e in eps]), jnp.float32)
        got = batched_return_estimate(r, V, A, rho, jnp.asarray(lengths),
                                      jnp.asarray(terms), 0.995, 0.95)
        for i, (T, term) in enumerate(zip(lengths, terms)):
            want = reference_recursion(*[np.asarray(x[i]) for x in
                                         (r, V, A, rho)], T, term, 0.995, 0.95)
            np.testing.assert_allclose(got[i, :T + 1], want[:T + 1],
                                       rtol=1e-4, atol=1e-4)

    def test_terminal_last_step(self):
        # Qret[T-1] must equal r[T] + gamma*V[T] regardless of lambda/rho
        L, T = 8, 4
        r, V, A, rho = make_episode(L, T, True)
        got = episode_return_estimate(
            jnp.asarray(r, jnp.float32), jnp.asarray(V, jnp.float32),
            jnp.asarray(A, jnp.float32), jnp.asarray(rho, jnp.float32),
            jnp.asarray(T, jnp.int32), jnp.asarray(True), 0.9, 0.95)
        np.testing.assert_allclose(got[T - 1], r[T] + 0.9 * V[T], rtol=1e-5)


class TestFullBufferSweep:
    """The whole-buffer sweep the refresh runs (ragged episode counts,
    L+1 not a power of two, the two affine modes and the sequential
    retraceExplore) against the float64 reference recursion, every
    episode and every time step."""

    @pytest.mark.parametrize("mode", ["retrace", "GAE", "retraceExplore"])
    @pytest.mark.parametrize("E,L", [(1, 3), (33, 20), (200, 36)])
    def test_matches_reference(self, E, L, mode):
        rng = np.random.RandomState(E)
        r = rng.randn(E, L + 1).astype(np.float32)
        V = rng.randn(E, L + 1).astype(np.float32)
        A = rng.randn(E, L + 1).astype(np.float32)
        rho = np.exp(rng.randn(E, L + 1)).astype(np.float32)
        lens = rng.randint(1, L + 1, E).astype(np.int32)
        lens[0] = L
        terms = rng.rand(E) > 0.5
        got = np.asarray(batched_return_estimate(
            *(jnp.asarray(x) for x in (r, V, A, rho, lens, terms)),
            0.995, 0.95, mode, err_baseline=0.3))
        want = reference_return_estimate(r, V, A, rho, lens, terms,
                                         0.995, 0.95, mode, err_baseline=0.3)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for e in range(E):
            np.testing.assert_array_equal(got[e, lens[e] + 1:], 0.0)

    def test_reference_by_hand(self):
        """The float64 reference itself, on a hand-computed episode."""
        r = np.asarray([[0.0, 1.0, 2.0, 3.0]])
        v = np.full_like(r, 0.5)
        zero = np.zeros_like(r)
        q = reference_return_estimate(r, v, zero, np.ones_like(r), [3],
                                      [False], 1.0, 1.0, "GAE")
        # lambda = gamma = 1: q[t] = sum of rewards after t + V[T]
        np.testing.assert_allclose(q[0], [6.5, 5.5, 3.5, 0.5])
