"""Adam optimizer with the reference's exact update rule + target weights.

Reference: source/smarties/Network/Optimizer.{h,cpp}. The compile-time
default switches (Settings/Bund.h:76-88) are ON: SMARTIES_SAFE_ADAM
(second moment floored at M1^2), SMARTIES_NESTEROV_ADAM (lookahead
numerator), SMARTIES_ADAMW (decoupled weight decay). The reference applies
*ascent*: param += eta * step (gradients produced by learners are ascent
directions, set on the output layer and backpropped).

Distributed: the reference all-reduces the summed gradient across learner
ranks with MPI_Iallreduce (Optimizer.cpp:110-119). Here gradients computed
under jit over a sharded batch are reduced by XLA automatically (psum via
GSPMD); the update itself is replicated, like the reference's
"update is deterministic: can be handled independently by each node".
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.utils.config import anneal_rate

NN_EPS = float(np.finfo(np.float32).eps)  # nnEPS (Bund.h:118)


class AdamState(NamedTuple):
    m1: dict     # first moment pytree
    m2: dict     # second moment pytree
    beta_t_1: jnp.ndarray
    beta_t_2: jnp.ndarray
    step: jnp.ndarray


class AdamConfig(NamedTuple):
    eta: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    lambda_: float = 0.0       # nnLambda, L2 (AdamW-style, decoupled)
    eps_anneal: float = 0.0    # epsAnneal for lr annealing
    anneal_lr: bool = True     # bAnnealLearnRate (Optimizer.h:45)


def adam_init(params) -> AdamState:
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    return AdamState(m1=zeros,
                     m2=jax.tree_util.tree_map(jnp.zeros_like, params),
                     beta_t_1=jnp.float32(0.9),
                     beta_t_2=jnp.float32(0.999),
                     step=jnp.int32(0))


def adam_step(params, grads, state: AdamState, cfg: AdamConfig,
              grad_factor):
    """One Adam ascent step. `grads` are summed ascent gradients; the
    reference divides by batchSize via `factor` (Optimizer.cpp:130).

    Returns (new_params, new_state).
    """
    b1, b2 = cfg.beta1, cfg.beta2
    eta = cfg.eta
    if cfg.anneal_lr:
        eta = anneal_rate(eta, state.step.astype(jnp.float32),
                          cfg.eps_anneal)
    # bias-corrected step size (Adam ctor, Optimizer.cpp:62-67)
    eta_t = eta * jnp.sqrt(1 - state.beta_t_2) / (1 - state.beta_t_1)

    def upd(w, g, m1, m2):
        dw = grad_factor * g  # ADAMW: penalty not in the moments
        m1n = b1 * m1 + (1 - b1) * dw
        m2n = b2 * m2 + (1 - b2) * dw * dw
        m2n = jnp.maximum(m2n, m1n * m1n)           # SAFE_ADAM
        numer = b1 * m1n + (1 - b1) * dw            # NESTEROV_ADAM
        ret = numer / (NN_EPS + jnp.sqrt(m2n))
        penal = -w * cfg.lambda_                    # AdamW decoupled decay
        return w + eta_t * (ret + penal), m1n, m2n

    flat_w, tdef = jax.tree_util.tree_flatten(params)
    flat_g = jax.tree_util.tree_flatten(grads)[0]
    flat_m1 = jax.tree_util.tree_flatten(state.m1)[0]
    flat_m2 = jax.tree_util.tree_flatten(state.m2)[0]
    out = [upd(w, g, m1, m2) for w, g, m1, m2
           in zip(flat_w, flat_g, flat_m1, flat_m2)]
    new_w = jax.tree_util.tree_unflatten(tdef, [o[0] for o in out])
    new_m1 = jax.tree_util.tree_unflatten(tdef, [o[1] for o in out])
    new_m2 = jax.tree_util.tree_unflatten(tdef, [o[2] for o in out])

    # beta_t *= beta, floored to 0 below nnEPS (Optimizer.cpp:156-160)
    bt1 = state.beta_t_1 * b1
    bt1 = jnp.where(bt1 < NN_EPS, 0.0, bt1)
    bt2 = state.beta_t_2 * b2
    bt2 = jnp.where(bt2 < NN_EPS, 0.0, bt2)
    return new_w, AdamState(new_m1, new_m2, bt1, bt2, state.step + 1)


class FlatAdamState(NamedTuple):
    """AdamState with the moments stored as ONE flat vector across all
    parameter leaves — the whole Adam sweep is a
    single fused elementwise kernel instead of one per leaf (the reference
    likewise runs Adam as one `omp for simd` sweep over the flat weight
    blob, Optimizer.cpp:122-155; Parameters.h stores weights flat)."""
    m1: jnp.ndarray
    m2: jnp.ndarray
    beta_t_1: jnp.ndarray
    beta_t_2: jnp.ndarray
    step: jnp.ndarray


def _flat_meta(params):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    shapes = [x.shape for x in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    return leaves, tdef, shapes, sizes


def _ravel(leaves):
    return jnp.concatenate([jnp.ravel(x) for x in leaves]) if len(leaves) > 1 \
        else jnp.ravel(leaves[0])


def adam_init_flat(params) -> FlatAdamState:
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(params))
    z = jnp.zeros((n,), jnp.float32)
    return FlatAdamState(m1=z, m2=z, beta_t_1=jnp.float32(0.9),
                         beta_t_2=jnp.float32(0.999), step=jnp.int32(0))


def adam_step_flat(params, grads, state: FlatAdamState, cfg: AdamConfig,
                   grad_factor):
    """Identical math to adam_step, over flat moment vectors."""
    leaves, tdef, shapes, sizes = _flat_meta(params)
    wv = _ravel(leaves)
    gv = _ravel(jax.tree_util.tree_flatten(grads)[0])

    b1, b2 = cfg.beta1, cfg.beta2
    eta = cfg.eta
    if cfg.anneal_lr:
        eta = anneal_rate(eta, state.step.astype(jnp.float32),
                          cfg.eps_anneal)
    eta_t = eta * jnp.sqrt(1 - state.beta_t_2) / (1 - state.beta_t_1)

    dw = grad_factor * gv
    m1n = b1 * state.m1 + (1 - b1) * dw
    m2n = b2 * state.m2 + (1 - b2) * dw * dw
    m2n = jnp.maximum(m2n, m1n * m1n)               # SAFE_ADAM
    numer = b1 * m1n + (1 - b1) * dw                # NESTEROV_ADAM
    ret = numer / (NN_EPS + jnp.sqrt(m2n))
    new_wv = wv + eta_t * (ret - wv * cfg.lambda_)  # AdamW decoupled decay

    offs = np.cumsum([0] + sizes)
    new_leaves = [jax.lax.dynamic_slice_in_dim(new_wv, int(offs[i]),
                                               sizes[i]).reshape(shapes[i])
                  for i in range(len(sizes))]
    new_params = jax.tree_util.tree_unflatten(tdef, new_leaves)

    bt1 = state.beta_t_1 * b1
    bt1 = jnp.where(bt1 < NN_EPS, 0.0, bt1)
    bt2 = state.beta_t_2 * b2
    bt2 = jnp.where(bt2 < NN_EPS, 0.0, bt2)
    return new_params, FlatAdamState(m1n, m2n, bt1, bt2, state.step + 1)


def update_target(params, target, target_delay: float, step):
    """Frozen/target weight update (Optimizer.cpp:163-178).

    targetDelay >= 1: hard copy every int(targetDelay) steps;
    0 < targetDelay < 1: Polyak averaging each step with rate targetDelay;
    targetDelay == 0: targets unused (returns `target` unchanged).
    """
    if target_delay <= 0:
        return target
    if target_delay >= 1:
        period = int(target_delay)
        do_copy = (step % period) == 0
        return jax.tree_util.tree_map(
            lambda t, w: jnp.where(do_copy, w, t), target, params)
    tau = target_delay
    return jax.tree_util.tree_map(lambda t, w: t + tau * (w - t),
                                  target, params)
