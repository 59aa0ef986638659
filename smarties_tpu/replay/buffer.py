"""On-device episode-slotted replay memory with ReF-ER state.

JAX re-design of the reference's replay layer
(source/smarties/ReplayMemory/{MemoryBuffer,Episode,MemoryProcessing}.*):
pointer-linked Episode objects + OpenMP sweeps become fixed-shape device
arrays [n_slots, max_len+1, ...] with validity masks, so that ingestion,
sampling, Retrace recomputation, ReF-ER bookkeeping and forgetting are all
jit-compiled masked array ops (no host round-trips in the hot path).

PACKED LAYOUT. All per-transition scalars live in ONE packed record array
`steps [E, L+1, R]` (record trailing) with channel order

    [ reward(1) | action(dimA) | mu(dimPol) | qret(1) |
      rho(1) | kl(1) | delta(1) | value(1) | advantage(1) ]

and the per-slot integers in `slot_meta [E, 3]` = [length, ep_id,
terminal]. Every gather/scatter indexes the LEADING dims with the record
trailing, and every hot write is a FULL-row scatter (no partial-width
`.at[ep, t, wb0:]` writes, no channel-major [R, E, L+1] indexing):
write_back re-emits the gathered fixed channels (bit-identical values)
alongside the new [rho..advantage] ones. The record also mirrors the
slot_meta integers as trailing channels (see _ch). A minibatch then
costs 2 gathers (states at t/t+1 fused; full records at t/t+1 fused,
meta riding along) and ONE fused [2B, R] full-row scatter + 1 far-count
add (write_back + the V(s_T) refresh), instead of ~8 gathers + 6
scatters with one array per field. `samp_cl [E, 2]` caches
[cumsum(len), episode-start-offset] for uniform sampling, rebuilt at
every commit/prune/clear (the only places lengths change); the RNG is
also hoisted out of train-step scan bodies (see algos/base.py
presample_uniform). Whether this layout is the fastest on the GPU is
not measured yet.

Array layout (state-indexed time axis, see ops/returns.py):
  t in [0, T]   : states; V/A/Qret; rho/kl/delta (rho[T] == 0)
  t in [1, T]   : rewards (reward received on arriving at state t)
  t in [0, T-1] : actions and behavior policies mu

Scalars carried in the state (reference MemoryBuffer.h:41-44): the ReF-ER
penalization weight beta, the annealed clip CmaxRet (and its inverse), and
the CMA cost-mix alpha.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.ops.returns import batched_return_estimate

F32 = jnp.float32
I32 = jnp.int32

# fixed scalar channels relative to the packed record layout
CH_REW = 0
N_TRAIL = 6          # qret, rho, kl, delta, value, advantage
# old per-field names accepted by ReplayState._replace for compatibility
_COMPAT_CHANNELS = {"rewards", "actions", "mus", "qret", "rho", "kl",
                    "delta", "value", "advantage", "length", "ep_id",
                    "terminal"}


def _ch(dim_action: int, dim_policy: int, dim_state_packed: int = 0):
    """(CH_ACT, CH_MU, CH_QRET, WB0, R): channel offsets for the packed
    per-step record. WB0 is the start of the write-back slice
    [rho, kl, delta, value, advantage] (the 5 fields of
    MiniBatch::setMseDklImpw + setValues, MiniBatch.h:161-188). The
    record additionally MIRRORS the slot_meta integers as three trailing
    f32 channels [length, ep_id, terminal] at R-3 (exact for len <=
    2^24 and ids < 2^24), replicated along the time axis — so the
    minibatch gather needs no separate slot_meta gather. slot_meta
    [E, 3] stays authoritative for full-array ops; the mirror is
    refreshed wherever slot_meta changes (commit scatter rows / prune /
    clear / rebalance).

    dim_state_packed > 0 (round-5, small-dim f32 envs): the RAW state
    row additionally rides in the record at [WB0+5, R-3), so the
    minibatch needs ONE fused gather total instead of two. States only
    ever change at episode commit (prune/clear touch meta only; write-backs re-emit the
    gathered channels bit-identically), so the mirror is synced exactly
    where commit_episodes_packed scatters. `states` [E, L+1, dimS]
    remains authoritative for full-array sweeps (stats, BPTT windows,
    checkpoints). uint8 image replays keep dim_state_packed == 0."""
    ch_act = 1
    ch_mu = ch_act + dim_action
    ch_qret = ch_mu + dim_policy
    wb0 = ch_qret + 1
    r = wb0 + 5 + dim_state_packed + 3
    return ch_act, ch_mu, ch_qret, wb0, r


def _sync_meta_mirror(steps, slot_meta):
    """Rewrite the trailing meta-mirror channels of `steps` from
    slot_meta (one dynamic-update-slice over the channel range)."""
    E, L1, R = steps.shape
    mirror = jnp.broadcast_to(
        slot_meta.astype(F32)[:, None, :], (E, L1, 3))
    return steps.at[:, :, R - 3:].set(mirror)


@dataclass(frozen=True)
class ReplayState:
    # episode storage
    states: jnp.ndarray      # [E, L+1, dimS] raw (unstandardized) states
    steps: jnp.ndarray       # [E, L+1, R] packed per-step record (above)
    slot_meta: jnp.ndarray   # [E, 3] i32 [length, ep_id, terminal]
    # ReF-ER / annealing scalars (MemoryBuffer.h:41-44)
    beta: jnp.ndarray        # penalization weight in [0, 1]
    alpha: jnp.ndarray       # CMA cost mix
    cmax_ret: jnp.ndarray    # 1 + anneal(C)
    cinv_ret: jnp.ndarray    # 1 / cmax_ret
    # running state/reward statistics (MDPdescriptor scaling fields)
    state_mean: jnp.ndarray  # [dimS]
    state_std: jnp.ndarray   # [dimS]
    state_scale: jnp.ndarray  # [dimS] == 1/std
    rew_mean: jnp.ndarray    # scalar (stays 0 unless OFFPOL_ADAPT)
    rew_std: jnp.ndarray     # scalar
    rew_scale: jnp.ndarray   # scalar == 1/std
    # counters (ReplayStatsCounters.h)
    n_seen_eps: jnp.ndarray      # i32 total episodes ever stored
    n_seen_steps: jnp.ndarray    # i32 total transitions ever stored
    n_pruned_eps: jnp.ndarray    # i32
    max_abs_error: jnp.ndarray   # stats.maxAbsError running est.
    # per-slot far-policy step counts, maintained incrementally by the
    # sampled-write-back path (the reference's per-episode fracFarPolSteps
    # aggregates updated atomically on sampling, Episode.h:112-145) and
    # recomputed exactly at every refresh sweep
    far_count: jnp.ndarray       # [E] f32
    # slots committed since the last return-estimator sweep: their qret is
    # zeros until refresh_new_returns runs (the at-ingest Retrace of
    # MemoryBuffer::terminateCurrentEpisode, batched per rollout chunk)
    qret_stale: jnp.ndarray      # [E] bool
    # V(s_T) side-channel (r5): the ONLY record position ever written
    # outside t < T is the value at t == length (truncated-episode
    # bootstrap refresh, MB.setValues(t+1, vNext), RACER_train.cpp:23-27)
    # — exactly one scalar per slot. Keeping it here lets the per-step
    # write-back scatter [B, R] rows instead of [2B, R].
    # INVARIANT: for valid slots, v_trunc[e] holds the value-channel
    # entry at t == length[e]; the `value` property substitutes it, so
    # every full-array consumer (return sweeps, checkpoints) sees the
    # exact pre-r5 array. Maintained at commit / write-backs / rebalance.
    v_trunc: jnp.ndarray         # [E] f32
    # cached [cumsum(valid len), episode start offset] i32 for uniform
    # sampling — rebuilt wherever lengths change (commit/prune/clear/
    # rebalance); per-SHARD local when the slot axis is sharded (exactly
    # what per-shard sampling wants)
    samp_cl: jnp.ndarray         # [E, 2] i32
    # static metadata needed to slice the packed record
    dim_action: int = field(default=0, metadata=dict(static=True))
    dim_policy: int = field(default=0, metadata=dict(static=True))
    # > 0: raw f32 states mirrored into the record at [WB0+5, R-3) so
    # the minibatch costs ONE gather (see _ch docstring)
    dim_state_packed: int = field(default=0, metadata=dict(static=True))

    # ---------------- NamedTuple-compat surface ----------------
    def _replace(self, **kw) -> "ReplayState":
        """dataclasses.replace plus pre-packing compatibility: the old
        per-field names (rho/kl/delta/value/advantage/qret/rewards/
        actions/mus and length/ep_id/terminal) are accepted and rewritten
        into the packed arrays as full-array channel updates (convenience
        surface for tests/tools; hot paths scatter into `steps`
        directly). Setting length/ep_id also refreshes the sampling
        cache."""
        compat = _COMPAT_CHANNELS & kw.keys()
        if compat:
            ch_act, ch_mu, ch_qret, wb0, _ = self._c
            sl = {"rewards": CH_REW, "qret": ch_qret, "rho": wb0,
                  "kl": wb0 + 1, "delta": wb0 + 2, "value": wb0 + 3,
                  "advantage": wb0 + 4}
            steps = kw.pop("steps", self.steps)
            sm = kw.pop("slot_meta", self.slot_meta)
            meta_touched = False
            val_arr = None
            for name in list(kw):
                if name in sl:
                    arr = kw.pop(name)
                    if name == "value":
                        val_arr = arr   # sync v_trunc below (needs the
                        # final lengths if they change in this call)
                    steps = steps.at[..., sl[name]].set(arr)
                elif name == "actions":
                    steps = steps.at[..., ch_act:ch_mu].set(kw.pop(name))
                elif name == "mus":
                    steps = steps.at[..., ch_mu:ch_qret].set(kw.pop(name))
                elif name in ("length", "ep_id", "terminal"):
                    i = ("length", "ep_id", "terminal").index(name)
                    sm = sm.at[:, i].set(kw.pop(name).astype(I32))
                    meta_touched = True
            if meta_touched:
                steps = _sync_meta_mirror(steps, sm)
            if val_arr is not None and "v_trunc" not in kw:
                lens = jnp.clip(sm[:, 0], 0, self.max_len)
                kw["v_trunc"] = jnp.take_along_axis(
                    jnp.broadcast_to(val_arr, self.steps.shape[:2]),
                    lens[:, None], axis=1)[:, 0]
            out = dataclasses.replace(self, steps=steps, slot_meta=sm,
                                      **kw)
            return rebuild_sample_cache(out) if meta_touched else out
        return dataclasses.replace(self, **kw)

    # ---------------- packed-channel views ----------------
    @property
    def _c(self):
        return _ch(self.dim_action, self.dim_policy,
                   self.dim_state_packed)

    @property
    def rewards(self):
        return self.steps[..., CH_REW]

    @property
    def actions(self):
        ch_act, ch_mu, _, _, _ = self._c
        return self.steps[..., ch_act:ch_mu]

    @property
    def mus(self):
        _, ch_mu, ch_qret, _, _ = self._c
        return self.steps[..., ch_mu:ch_qret]

    @property
    def qret(self):
        return self.steps[..., self._c[2]]

    @property
    def rho(self):
        return self.steps[..., self._c[3] + 0]

    @property
    def kl(self):
        return self.steps[..., self._c[3] + 1]

    @property
    def delta(self):
        return self.steps[..., self._c[3] + 2]

    @property
    def value(self):
        """Effective value array: the stored channel with the v_trunc
        side-channel substituted at t == length (see v_trunc field note;
        the raw channel entry at T is stale by design)."""
        v = self.steps[..., self._c[3] + 3]
        t = jnp.arange(v.shape[1])
        at_T = (t[None, :] == jnp.clip(self.length, 0, self.max_len)[:, None]) \
            & self.valid_slots()[:, None]
        return jnp.where(at_T, self.v_trunc[:, None], v)

    @property
    def advantage(self):
        return self.steps[..., self._c[3] + 4]

    @property
    def length(self):
        return self.slot_meta[:, 0]

    @property
    def ep_id(self):
        return self.slot_meta[:, 1]

    @property
    def terminal(self):
        return self.slot_meta[:, 2] > 0

    # ---------------- derived masks / counts ----------------
    @property
    def n_slots(self) -> int:
        return self.states.shape[0]

    @property
    def max_len(self) -> int:
        return self.states.shape[1] - 1

    def valid_slots(self):
        return self.ep_id >= 0

    def valid_steps(self):
        """[E, L+1] mask of transition indices t < T of valid episodes."""
        t = jnp.arange(self.states.shape[1])
        return (t[None, :] < self.length[:, None]) & self.valid_slots()[:, None]

    def n_stored_steps(self):
        return jnp.sum(jnp.where(self.valid_slots(), self.length, 0))

    def n_stored_eps(self):
        return jnp.sum(self.valid_slots().astype(I32))

    def scaled_rewards(self):
        """(r - mean) * scale (Episode::scaledReward, Episode.h:185-189)."""
        return (self.rewards - self.rew_mean) * self.rew_scale

    def standardized_states(self):
        """(s - mean) * scale (Episode::standardizedState, :171-183)."""
        return (self.states - self.state_mean) * self.state_scale


jax.tree_util.register_dataclass(
    ReplayState,
    data_fields=[f.name for f in dataclasses.fields(ReplayState)
                 if not f.metadata.get("static")],
    meta_fields=["dim_action", "dim_policy", "dim_state_packed"])


def pack_step_record(rewards, actions, mus, qret, rho, kl, delta, value,
                     advantage):
    """Assemble a [..., R] packed record from per-field arrays (leading
    dims arbitrary; scalar fields [...], vector fields [..., d])."""
    one = lambda x: x[..., None]
    return jnp.concatenate(
        [one(rewards), actions, mus, one(qret), one(rho), one(kl),
         one(delta), one(value), one(advantage)], axis=-1)


def safe_mu(mdp) -> np.ndarray:
    """A numerically-safe behavior-policy vector for EMPTY replay slots:
    unit-stdev standard normal for continuous policies, uniform
    probabilities for discrete. Sampling can touch empty slots when a
    replay SHARD holds no episodes yet (multi-device meshes); safe mu
    keeps the importance-weight/KL math finite there (the per-sample
    gradient is additionally masked by MiniBatch.valid)."""
    if mdp.is_discrete:
        n = mdp.max_action_label
        return np.full((n,), 1.0 / n, np.float32)
    nA = mdp.dim_action
    return np.concatenate([np.zeros(nA), np.ones(nA)]).astype(np.float32)


def init_replay(n_slots: int, max_len: int, dim_state: int, dim_action: int,
                dim_policy: int, clip_imp_weight: float = 4.0,
                state_dtype=jnp.float32, mu_init=None,
                pack_states: bool = False) -> ReplayState:
    """Initial scalars follow MemoryBuffer.h:41-44: beta starts at 1e-4
    (near-full KL-penalty mode) when ReF-ER clipping is active, CmaxRet at
    1 + C, CinvRet at 1/C.

    state_dtype: storage dtype for raw states — pass jnp.uint8 for image
    observations (Atari-scale buffers; the reference stores Fval=f32 but
    has no per-episode padding; byte storage keeps the padded slot layout
    within HBM). Standardization promotes to f32 at gather time.

    mu_init: [dim_policy] fill value for behavior policies of empty slots
    (see safe_mu) — keeps policy math finite if an empty slot is sampled.

    pack_states: mirror the raw state rows into the packed record so the
    minibatch needs ONE gather (f32 states only; see _ch docstring).
    """
    E, L1 = n_slots, max_len + 1
    C = clip_imp_weight
    if pack_states:
        assert state_dtype == jnp.float32, \
            "pack_states requires f32 states (uint8 image replays keep " \
            "the separate state array)"
    dsp = dim_state if pack_states else 0
    _, ch_mu, ch_qret, _, R = _ch(dim_action, dim_policy, dsp)
    steps = jnp.zeros((E, L1, R), F32)
    if mu_init is not None:
        steps = steps.at[:, :, ch_mu:ch_qret].set(
            jnp.asarray(mu_init, F32))
    slot_meta = jnp.concatenate(
        [jnp.zeros((E, 1), I32), -jnp.ones((E, 1), I32),
         jnp.zeros((E, 1), I32)], axis=1)
    steps = _sync_meta_mirror(steps, slot_meta)
    z = lambda *s: jnp.zeros(s, F32)
    return ReplayState(
        states=jnp.zeros((E, L1, dim_state), state_dtype),
        steps=steps, slot_meta=slot_meta,
        beta=jnp.float32(1.0 if C <= 0 else 1e-4),
        alpha=jnp.float32(0.5),
        cmax_ret=jnp.float32(1.0 + C),
        cinv_ret=jnp.float32(1.0 / C if C > 0 else 1.0),
        state_mean=z(dim_state), state_std=jnp.ones((dim_state,), F32),
        state_scale=jnp.ones((dim_state,), F32),
        rew_mean=jnp.float32(0.0), rew_std=jnp.float32(1.0),
        rew_scale=jnp.float32(1.0),
        n_seen_eps=jnp.int32(0), n_seen_steps=jnp.int32(0),
        n_pruned_eps=jnp.int32(0), max_abs_error=jnp.float32(0.0),
        far_count=jnp.zeros((E,), F32),
        qret_stale=jnp.zeros((E,), bool),
        v_trunc=jnp.zeros((E,), F32),
        samp_cl=jnp.zeros((E, 2), I32),
        dim_action=dim_action, dim_policy=dim_policy,
        dim_state_packed=dsp,
    )


def rebuild_sample_cache(rs: ReplayState) -> ReplayState:
    """Refresh the cached [cumsum(len), episode-start] pair used by
    uniform sampling. Must run after any operation that changes lengths/
    validity (commit/prune/clear/rebalance all do)."""
    lens = jnp.where(rs.valid_slots(), rs.length, 0)
    csum = jnp.cumsum(lens)
    cl = jnp.stack([csum, csum - lens], axis=1)
    return rs._replace(samp_cl=cl)


# ---------------------------------------------------------------------------
# episode aggregates (Episode.h:83-85, computed on the fly from the arrays
# instead of incrementally-updated atomics)
# ---------------------------------------------------------------------------

def episode_aggregates(rs: ReplayState):
    """Per-slot (frac_far_policy, avg_kl, avg_sq_err) over valid steps."""
    mask = rs.valid_steps().astype(F32)
    n = jnp.maximum(jnp.sum(mask, axis=1), 1.0)
    far = is_far_policy(rs.rho, rs.cmax_ret, rs.cinv_ret) & (mask > 0)
    frac_far = jnp.sum(far.astype(F32), axis=1) / n
    avg_kl = jnp.sum(rs.kl * mask, axis=1) / n
    avg_err = jnp.sum(rs.delta * rs.delta * mask, axis=1) / n
    return frac_far, avg_kl, avg_err


def is_far_policy(rho, cmax, cinv):
    """1/C < rho < C test (Episode.h:28-33); no filtering when C <= 1."""
    off = (rho > cmax) | (rho < cinv)
    return (cmax > 1.0) & off


def n_far_policy_steps_exact(rs: ReplayState):
    """Full-buffer recount (used at refresh sweeps to correct drift)."""
    far = is_far_policy(rs.rho, rs.cmax_ret, rs.cinv_ret) & rs.valid_steps()
    return jnp.sum(far.astype(I32))


def far_count_exact(rs: ReplayState):
    """Per-slot exact far-policy counts [E]."""
    far = is_far_policy(rs.rho, rs.cmax_ret, rs.cinv_ret) & rs.valid_steps()
    return jnp.sum(far.astype(F32), axis=1)


def n_far_policy_steps(rs: ReplayState):
    """Incrementally-maintained total (one [E] reduction per call)."""
    return jnp.sum(rs.far_count).astype(I32)


# ---------------------------------------------------------------------------
# ingestion: commit finished episodes from per-env in-progress buffers
# ---------------------------------------------------------------------------

def _keep_priority(rs: ReplayState, filter_algo: str):
    """Higher = kept longer. Empty slots always get -inf (filled first).

    Reference: getERfilterAlgo (MemoryProcessing.cpp:261-298) sorts episodes
    so the ones to delete are at the back; this is the equivalent key.
    """
    if filter_algo in ("oldest", "default"):
        score = rs.ep_id.astype(F32)
    elif filter_algo == "farpolfrac":
        frac_far, _, _ = episode_aggregates(rs)
        score = -frac_far
    elif filter_algo == "maxkldiv":
        _, avg_kl, _ = episode_aggregates(rs)
        score = -avg_kl
    elif filter_algo == "minerror":
        _, _, avg_err = episode_aggregates(rs)
        score = avg_err
    else:
        raise ValueError(filter_algo)
    return jnp.where(rs.valid_slots(), score, -jnp.inf)


def commit_episodes_packed(rs: ReplayState, ep_states, ep_steps, ep_length,
                           ep_terminal, done_mask, max_tot_obs: int,
                           filter_algo: str = "oldest",
                           ids_override=None):
    """Scatter finished PACKED episodes into replay slots and prune.

    ep_states [V, L+1, dimS], ep_steps [V, L+1, R] (record layout
    above), ep_length [V] i32, ep_terminal [V] bool, done_mask [V]
    bool. Replaces the reference's mutex-guarded pushBackEpisode +
    applyEpisodesRemovalAlgo (MemoryBuffer.cpp:479-520,
    MemoryProcessing.cpp:327-351).

    Victim-slot choice: the K lowest keep-priority slots (empty slots
    first, then the filter criterion) — equivalent to sort+remove-from-
    back. 5 scatters total (states/steps/slot_meta/far_count/qret_stale).
    """
    V = done_mask.shape[0]
    prio = _keep_priority(rs, filter_algo)
    order = jnp.argsort(prio)            # ascending: worst first
    done_rank = jnp.cumsum(done_mask.astype(I32)) - 1   # [V]
    slot_for_env = order[jnp.clip(done_rank, 0, rs.n_slots - 1)]
    # envs that are not done scatter into a trash position via mode='drop'
    tgt = jnp.where(done_mask, slot_for_env, rs.n_slots)

    new_ids = (rs.n_seen_eps + done_rank if ids_override is None
               else ids_override)
    n_done = jnp.sum(done_mask.astype(I32))

    def put(dst, src):
        return dst.at[tgt].set(src, mode="drop")

    ep_meta = jnp.stack([ep_length.astype(I32), new_ids.astype(I32),
                         ep_terminal.astype(I32)], axis=1)
    # rows carry the state mirror (when packed) + the meta mirror in
    # their trailing channels: append both (per-field callers pack
    # R-3-S wide records) or overwrite the meta only (full-R payloads,
    # e.g. rebalance shipments, already carry their state channels)
    L1 = rs.steps.shape[1]
    R = rs.steps.shape[2]
    S = rs.dim_state_packed
    mrr = jnp.broadcast_to(ep_meta.astype(F32)[:, None, :], (V, L1, 3))
    if ep_steps.shape[-1] == R - 3 - S:
        tail = ([ep_states.astype(F32), mrr] if S else [mrr])
        ep_steps = jnp.concatenate([ep_steps] + tail, axis=-1)
    elif ep_steps.shape[-1] == R:
        ep_steps = ep_steps.at[:, :, R - 3:].set(mrr)
    else:
        raise ValueError(
            f"ep_steps width {ep_steps.shape[-1]} matches neither the "
            f"per-field record width {R - 3 - S} nor the full width {R}")
    # v_trunc invariant: the value-channel entry at t == length of each
    # arriving episode (acting-time V(s_T); exact for full-R payloads
    # because rebalance patches the channel before shipping)
    ch_value = rs._c[3] + 3
    v_at_T = jnp.take_along_axis(
        ep_steps[..., ch_value],
        jnp.clip(ep_length.astype(I32), 0, rs.max_len)[:, None],
        axis=1)[:, 0]
    rs = rs._replace(
        states=put(rs.states, ep_states),
        steps=put(rs.steps, ep_steps),
        slot_meta=put(rs.slot_meta, ep_meta),
        # fresh episodes arrive with rho == 1 everywhere: zero far steps
        far_count=put(rs.far_count, jnp.zeros(V, F32)),
        qret_stale=put(rs.qret_stale, jnp.ones(V, bool)),
        v_trunc=put(rs.v_trunc, v_at_T),
        n_seen_eps=rs.n_seen_eps + n_done,
        n_seen_steps=rs.n_seen_steps + jnp.sum(
            jnp.where(done_mask, ep_length, 0)),
    )
    return prune_to_capacity(rs, max_tot_obs, filter_algo)


def commit_episodes(rs: ReplayState, ep_states, ep_actions, ep_mus,
                    ep_rewards, ep_value, ep_advantage, ep_qret, ep_rho,
                    ep_length, ep_terminal, done_mask,
                    max_tot_obs: int, filter_algo: str = "oldest"):
    """Per-field commit wrapper: packs the record then scatters once
    (kl/delta start at zero for fresh episodes)."""
    z = jnp.zeros_like(ep_rho)
    ep_steps = pack_step_record(ep_rewards, ep_actions, ep_mus, ep_qret,
                                ep_rho, z, z, ep_value, ep_advantage)
    return commit_episodes_packed(rs, ep_states, ep_steps, ep_length,
                                  ep_terminal, done_mask, max_tot_obs,
                                  filter_algo)


def prune_to_capacity(rs: ReplayState, max_tot_obs: int, filter_algo: str):
    """Invalidate lowest-priority episodes until total steps fit.

    Reference: applyEpisodesRemovalAlgo (MemoryProcessing.cpp:327-351):
    remove from the sorted back while (total - candidate.len) > maxTotObs.
    Equivalent: in keep-priority-descending order keep episode i iff the
    cumulative steps *before* it are <= maxTotObs. Also refreshes the
    sampling cache (this is the final step of every commit).
    """
    prio = _keep_priority(rs, filter_algo)
    order = jnp.argsort(-prio)  # descending: best kept first
    lens = jnp.where(rs.valid_slots(), rs.length, 0)[order]
    csum_before = jnp.cumsum(lens) - lens
    keep_sorted = csum_before <= max_tot_obs
    keep = jnp.zeros((rs.n_slots,), bool).at[order].set(keep_sorted)
    keep = keep & rs.valid_slots()
    pruned = rs.n_stored_eps() - jnp.sum(keep.astype(I32))
    # invalidate: length -> 0, ep_id -> -1, terminal kept (unused when
    # invalid)
    inval = (rs.slot_meta * jnp.asarray([0, 0, 1], I32)
             + jnp.asarray([0, -1, 0], I32))
    sm = jnp.where(keep[:, None], rs.slot_meta, inval)
    rs = rs._replace(
        slot_meta=sm,
        steps=_sync_meta_mirror(rs.steps, sm),
        far_count=jnp.where(keep, rs.far_count, 0.0),
        n_pruned_eps=rs.n_pruned_eps + pruned,
    )
    return rebuild_sample_cache(rs)


def clear_all(rs: ReplayState) -> ReplayState:
    """Invalidate every episode (PPO epoch-end clearAll,
    MemoryBuffer clearAll / PPO.cpp:105-112)."""
    inval = (rs.slot_meta * jnp.asarray([0, 0, 1], I32)
             + jnp.asarray([0, -1, 0], I32))
    return rebuild_sample_cache(rs._replace(
        slot_meta=inval, steps=_sync_meta_mirror(rs.steps, inval)))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_uniform(key, rs: ReplayState, batch: int):
    """Uniform over stored transitions; returns (ep_idx, t_idx) [batch].

    Reference: Sample_uniform (Sampling.cpp:49-99). The reference dedups and
    sorts for cache locality; with B << N collisions are negligible and
    gathers are order-independent here, so plain iid draws are used.
    Uses the cached [cumsum(len), start] pair (ONE gather)."""
    cl = rs.samp_cl
    total = cl[-1, 0]
    flat = jax.random.randint(key, (batch,), 0, jnp.maximum(total, 1))
    ep = jnp.searchsorted(cl[:, 0], flat, side="right").astype(I32)
    ep = jnp.clip(ep, 0, rs.n_slots - 1)
    t = (flat - cl[ep, 1]).astype(I32)
    return ep, t


def sample_episodes(key, rs: ReplayState, batch: int):
    """Uniform over stored episodes (bSampleEpisodes mode,
    Sampling.cpp:55-81). Returns episode slot indices [batch]."""
    valid = rs.valid_slots()
    p = valid.astype(F32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return jax.random.choice(key, rs.n_slots, (batch,), p=p).astype(I32)


def sample_per_rank(key, rs: ReplayState, batch: int, beta_annealed=1.0):
    """Rank-based prioritized sampling (TSample_impRank, Sampling.cpp:101-169).

    Probability ~ 1/rank of |TD error| over stored transitions; importance
    weights ~ (1/(N p)) ** beta normalized by max (reference annealed
    PER beta exponent, MemoryBuffer.cpp:409-427). NOTE the reference
    computes but never applies the PER weight to gradients
    (Approximator.h:196 is commented out); same here.
    Returns (ep_idx, t_idx, importance_weight).
    """
    mask = rs.valid_steps()
    err = jnp.where(mask, jnp.abs(rs.delta), -1.0).reshape(-1)
    n = err.shape[0]
    order = jnp.argsort(-err)                 # descending error
    rank = jnp.zeros((n,), F32).at[order].set(
        jnp.arange(1, n + 1, dtype=F32))
    p = jnp.where(mask.reshape(-1), 1.0 / rank, 0.0)
    p = p / jnp.sum(p)
    flat = jax.random.choice(key, n, (batch,), p=p)
    L1 = rs.states.shape[1]
    ep, t = (flat // L1).astype(I32), (flat % L1).astype(I32)
    n_data = jnp.maximum(rs.n_stored_steps().astype(F32), 1.0)
    w = (1.0 / (n_data * p[flat])) ** beta_annealed
    w = w / jnp.max(w)
    return ep, t, w


def sample_per_err(key, rs: ReplayState, batch: int):
    """TD-error-proportional prioritized sampling (TSample_impErr,
    Sampling.cpp:172-225): p ~ |delta| + eps over stored transitions."""
    mask = rs.valid_steps()
    p = jnp.where(mask, jnp.abs(rs.delta) + 1e-3, 0.0).reshape(-1)
    p = p / jnp.maximum(jnp.sum(p), 1e-9)
    n = p.shape[0]
    flat = jax.random.choice(key, n, (batch,), p=p)
    L1 = rs.states.shape[1]
    return (flat // L1).astype(I32), (flat % L1).astype(I32)


def sample_per_seq(key, rs: ReplayState, batch: int):
    """Episode-level prioritized sampling (Sample_impSeq,
    Sampling.cpp:229-296): episodes weighted by average squared TD error,
    then a uniform step within the episode."""
    mask = rs.valid_steps().astype(F32)
    n = jnp.maximum(jnp.sum(mask, axis=1), 1.0)
    avg_err = jnp.sum(rs.delta * rs.delta * mask, axis=1) / n
    p = jnp.where(rs.valid_slots(), avg_err + 1e-3, 0.0)
    p = p / jnp.maximum(jnp.sum(p), 1e-9)
    k1, k2 = jax.random.split(key)
    ep = jax.random.choice(k1, rs.n_slots, (batch,), p=p).astype(I32)
    u = jax.random.uniform(k2, (batch,))
    t = (u * rs.length[ep].astype(F32)).astype(I32)
    return ep, jnp.clip(t, 0, rs.max_len)


def sample(key, rs: ReplayState, batch: int, algo: str = "uniform"):
    """Sampler dispatch (Sampling.cpp:298-336 factory from
    dataSamplingAlgo)."""
    if algo in ("uniform", "default"):
        return sample_uniform(key, rs, batch)
    if algo == "PERrank":
        ep, t, _ = sample_per_rank(key, rs, batch)
        return ep, t
    if algo == "PERerr":
        return sample_per_err(key, rs, batch)
    if algo == "PERseq":
        return sample_per_seq(key, rs, batch)
    raise ValueError(f"unknown dataSamplingAlgo '{algo}'")


# ---------------------------------------------------------------------------
# ReF-ER rule 2 (beta fixed point) + annealed C (rule 1 schedule)
# ---------------------------------------------------------------------------

def update_beta_alpha(rs: ReplayState, batch_size: int, max_tot_obs: int,
                      penal_tol: float, axis_name=None):
    """beta/alpha fixed-point iteration.

    Reference: MemoryProcessing::updateCounters (MemoryProcessing.cpp:46-92):
    learnRefer = 0.1 * B / max(maxN, nData);
    beta -> 0 if fracOffPol > D else -> 1.
    The reference uses one-step-stale global counts (DelayedReductor) to hide
    MPI latency; on the device the exact count is a single masked
    reduction (psum across learner shards when axis_name is given — the
    MPI_Iallreduce of the reference, MemoryProcessing.cpp:56-58), so the
    current value is used (same fixed point, no latency to hide).

    batch_size and max_tot_obs are GLOBAL totals (the reference uses the
    global settings values here, HyperParameters pre-split).
    """
    n_data = rs.n_stored_steps()
    n_far = n_far_policy_steps(rs)
    if axis_name is not None:
        n_data = jax.lax.psum(n_data, axis_name)
        n_far = jax.lax.psum(n_far, axis_name)
    frac_off = n_far.astype(F32) / jnp.maximum(n_data.astype(F32), 1.0)
    learn_r = 0.1 * batch_size / jnp.maximum(
        jnp.float32(max_tot_obs), n_data.astype(F32))

    def fix_point(val, go_to_0):
        lr = jnp.minimum(learn_r, val)
        to0 = (1 - lr) * val
        to1 = (1 - lr) * val + jnp.minimum(learn_r, 1 - val)
        return jnp.where(go_to_0, to0, to1)

    beta = fix_point(rs.beta, frac_off > penal_tol)
    alpha = fix_point(rs.alpha, jnp.abs(penal_tol - frac_off) < 1e-3)
    return rs._replace(beta=beta, alpha=alpha), frac_off


def update_cmax(rs: ReplayState, n_grad_steps, clip_imp_weight: float,
                eps_anneal: float):
    """CmaxRet = 1 + annealRate(C, step, epsAnneal)
    (updateTrainingStatistics, MemoryProcessing.cpp:193-197)."""
    c = 1.0 + clip_imp_weight / (1.0 + n_grad_steps.astype(F32) * eps_anneal)
    return rs._replace(cmax_ret=c, cinv_ret=1.0 / c)


# ---------------------------------------------------------------------------
# state/reward running statistics
# ---------------------------------------------------------------------------

def update_state_rew_stats(rs: ReplayState, learn_rate, b_init: bool = False,
                           adapt_state_scale: bool = True, axis_name=None):
    """Annealed running mean/std of stored states and rewards.

    Reference: MemoryProcessing::updateRewardsStats
    (MemoryProcessing.cpp:94-185): accumulate E[x - old_mean] and
    E[(x-old_mean)^2] over the whole buffer, then
      mean += lr * Evar;  var = Evar2 - Evar^2*(2lr - lr^2);
      std += lr * (sqrt(var) - std);  scale = 1/std.
    b_init uses lr == 1 (exact stats). adapt_state_scale mirrors
    SMARTIES_OFFPOL_ADAPT_STSCALE=1 (Bund.h:24).
    """
    wr = jnp.float32(1.0) if b_init else jnp.minimum(jnp.float32(1.0),
                                                     learn_rate)
    ws = wr if adapt_state_scale else jnp.float32(0.0)

    def _gsum(x):
        """Cross-shard sum (reference: StateRewRdx DelayedReductor allreduce,
        MemoryProcessing.cpp:139-150)."""
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    # rewards: entries t in [1, T]
    t = jnp.arange(rs.steps.shape[1])
    rmask = ((t[None, :] >= 1) & (t[None, :] <= rs.length[:, None])
             & rs.valid_slots()[:, None]).astype(F32)
    count = jnp.maximum(_gsum(jnp.sum(rmask)), 1.0)
    dr = (rs.rewards - rs.rew_mean) * rmask
    evar_r = _gsum(jnp.sum(dr)) / count
    evar2_r = _gsum(jnp.sum(dr * dr)) / count

    def upd(mean, std, lr, evar, evar2):
        new_mean = mean + lr * evar
        var = evar2 - evar * evar * (2 * lr - lr * lr)
        var = jnp.maximum(var, np.finfo(np.float32).eps)
        new_std = std + lr * (jnp.sqrt(var) - std)
        return new_mean, new_std, 1.0 / new_std

    # NOTE: the reference keeps rewardsMean = 0 unless a compile flag sets
    # it; updateStats is applied to the second moment only through mean
    # updates too — we apply the same update to both, matching the code.
    rmean, rstd, rscale = upd(rs.rew_mean, rs.rew_std, wr, evar_r, evar2_r)

    smask = ((t[None, :] <= rs.length[:, None])
             & rs.valid_slots()[:, None]).astype(F32)[..., None]
    scount = jnp.maximum(_gsum(jnp.sum(smask)), 1.0)
    ds = (rs.states - rs.state_mean) * smask
    evar_s = _gsum(jnp.sum(ds, axis=(0, 1))) / scount
    evar2_s = _gsum(jnp.sum(ds * ds, axis=(0, 1))) / scount
    smean, sstd, sscale = upd(rs.state_mean, rs.state_std, ws,
                              evar_s, evar2_s)

    return rs._replace(rew_mean=rmean, rew_std=rstd, rew_scale=rscale,
                       state_mean=smean, state_std=sstd, state_scale=sscale)


# ---------------------------------------------------------------------------
# full-buffer return-estimator recomputation
# ---------------------------------------------------------------------------

def _set_qret(rs: ReplayState, qret) -> ReplayState:
    """Write the qret channel of the packed record (full-array channel
    update; runs at the amortized refresh cadence, not per step)."""
    return rs._replace(steps=rs.steps.at[:, :, rs._c[2]].set(qret))


def refresh_new_returns(rs: ReplayState, gamma: float, lam: float,
                        mode: str = "retrace"):
    """Return-estimator computation for freshly-committed episodes only
    (qret_stale slots) — the at-ingest Retrace of
    MemoryBuffer::terminateCurrentEpisode (MemoryBuffer.cpp:118-170),
    batched once per rollout chunk."""
    if mode == "none":
        return rs._replace(qret_stale=jnp.zeros_like(rs.qret_stale))
    qret = batched_return_estimate(
        rs.scaled_rewards(), rs.value, rs.advantage, rs.rho,
        rs.length, rs.terminal, gamma, lam, mode,
        err_baseline=rs.max_abs_error)
    sel = (rs.qret_stale & rs.valid_slots())[:, None]
    rs = _set_qret(rs, jnp.where(sel, qret, rs.qret))
    return rs._replace(qret_stale=jnp.zeros_like(rs.qret_stale))


def rebalance_shards(rs: ReplayState, axis_name: str, k_max: int = 8,
                     max_tot_obs: int = 2 ** 30,
                     filter_algo: str = "oldest") -> ReplayState:
    """Cross-shard episode balancing: shards holding more episodes than
    the mesh average ship up to k_max episodes to their ring neighbor.

    Device-side analog of the reference's round-robin episode sharing among
    workerless masters (DataCoordinator.cpp:91-112): called inside the
    shard_map'd refresh program (every-1000-steps cadence), so repeated
    one-hop ring pushes even the loads out like the reference's
    episode-by-episode round robin. Prevents starved (empty) shards from
    skewing per-shard uniform sampling.
    """
    n_shards = jax.lax.psum(1, axis_name)
    n_eps = rs.n_stored_eps()
    mean_eps = jax.lax.pmean(n_eps.astype(F32), axis_name)
    n_ship = jnp.clip((n_eps.astype(F32) - mean_eps).astype(I32), 0, k_max)

    # pick the n_ship lowest keep-priority valid episodes (they would be
    # pruned first anyway; "oldest" under the default filter)
    prio = _keep_priority(rs, filter_algo)
    order = jnp.argsort(prio)                       # worst first
    take = jnp.arange(k_max)
    slots = order[jnp.clip(take, 0, rs.n_slots - 1)]
    ship = (take < n_ship) & (rs.ep_id[slots] >= 0)

    # zero the kl/delta channels of the shipped records (commit semantics:
    # fresh arrivals start with kl = delta = 0, as the per-field commit)
    wb0 = rs._c[3]
    ship_steps = rs.steps[slots]
    ship_steps = ship_steps.at[:, :, wb0 + 1:wb0 + 3].set(0.0)
    # materialize the v_trunc side-channel into the shipped records (the
    # raw channel entry at T is stale by design; the receiver's commit
    # re-derives its v_trunc from the record)
    ship_steps = ship_steps.at[
        jnp.arange(slots.shape[0]),
        jnp.clip(rs.length[slots], 0, rs.max_len),
        wb0 + 3].set(rs.v_trunc[slots])
    payload = dict(
        states=rs.states[slots], steps=ship_steps,
        length=rs.length[slots], terminal=rs.terminal[slots], ship=ship)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    payload = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, axis_name, perm), payload)

    # sender side: invalidate shipped slots
    drop = jnp.zeros((rs.n_slots,), bool).at[slots].set(ship)
    inval = (rs.slot_meta * jnp.asarray([0, 0, 1], I32)
             + jnp.asarray([0, -1, 0], I32))
    rs = rs._replace(
        slot_meta=jnp.where(drop[:, None], inval, rs.slot_meta),
        far_count=jnp.where(drop, 0.0, rs.far_count))

    # receiver side: insert the neighbor's episodes (commit bookkeeping
    # counts them as seen; undo that — they are migrated, not new).
    # Migrated kl/delta travel inside the packed record unchanged (the
    # pre-packing layout zeroed them; both are rewritten by the next
    # sampled write-back and excluded from gradients either way).
    seen_eps0, seen_steps0 = rs.n_seen_eps, rs.n_seen_steps
    rs = commit_episodes_packed(
        rs, payload["states"], payload["steps"], payload["length"],
        payload["terminal"], payload["ship"], max_tot_obs, filter_algo)
    return rs._replace(n_seen_eps=seen_eps0, n_seen_steps=seen_steps0)


def recompute_returns(rs: ReplayState, gamma: float, lam: float,
                      mode: str = "retrace"):
    """Backward recursion over every stored episode.

    Reference cadence: at episode ingest (MemoryBuffer.cpp:118-170) and full
    sweeps every 1000 grad steps / after scaling updates
    (updateTrainingStatistics + rescaleAllReturnEstimator,
    MemoryProcessing.cpp:187-259, :460-481). Also resyncs the incremental
    far-policy counts exactly (the reference's bRecomputeProperties
    updateCumulative sweep).
    """
    rs = rs._replace(far_count=far_count_exact(rs),
                     qret_stale=jnp.zeros_like(rs.qret_stale))
    if mode == "none":
        return rs
    qret = batched_return_estimate(
        rs.scaled_rewards(), rs.value, rs.advantage, rs.rho,
        rs.length, rs.terminal, gamma, lam, mode,
        err_baseline=rs.max_abs_error)
    valid = rs.valid_slots()[:, None]
    return _set_qret(rs, jnp.where(valid, qret, 0.0))
