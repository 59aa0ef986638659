"""MDP problem description: state/action spaces, scaling, codecs.

JAX equivalent of the reference's MDPdescriptor / StateInfo /
ActionInfo (source/smarties/Core/StateAction.h). All device-side mappings are
pure jnp functions over static (python-level) metadata, so they trace cleanly
under jit and vmap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class MDPSpec:
    """Static problem description.

    Reference: MDPdescriptor (Core/StateAction.h:47-123). Fields keep the
    reference's semantics:

    - bounded continuous actions are produced by the learner in an unbounded
      space and squashed by tanh then affine-mapped into [lower, upper]
      (StateAction.h:284-295);
    - discrete multi-component actions are flattened to a single label with
      mixed-radix shifts (StateAction.h:305-341);
    - only dims with ``observable[i]`` are fed to the network; the rest are
      latent, stored for postprocessing (StateAction.h:125-203).
    """

    dim_state: int
    dim_action: int
    # continuous-action metadata
    bounded: Tuple[bool, ...] = ()          # per-dim: squash through tanh
    upper_action: Tuple[float, ...] = ()
    lower_action: Tuple[float, ...] = ()
    # discrete-action metadata: n values per action component (empty => continuous)
    discrete_values: Tuple[int, ...] = ()
    # observability mask over state dims
    observable: Tuple[bool, ...] = ()
    # number of past observations appended to current (frame stacking),
    # reference: nAppendedObs (StateAction.h:58, Episode.h:171-183)
    n_appended_obs: int = 0
    # conv preprocessing stack: tuples (in_w, in_h, in_c, out_c, filter,
    # stride), reference: Conv2D_Descriptor via setPreprocessingConv2d
    conv_layers: Tuple[Tuple[int, int, int, int, int, int], ...] = ()
    # agents within one env instance
    n_agents_per_env: int = 1
    # shared exploration noise across agents (Agent.h:315-362)
    shared_noise: bool = False
    # optional user-provided state box (setStateScales,
    # Communicator.cpp:98-122): seeds the state-standardization stats
    # until the online estimates warm up; mean=(u+l)/2, std=|u-l|
    state_upper: Tuple[float, ...] = ()
    state_lower: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.observable:
            object.__setattr__(self, "observable",
                               tuple([True] * self.dim_state))
        if not self.is_discrete:
            if not self.bounded:
                object.__setattr__(self, "bounded",
                                   tuple([False] * self.dim_action))
            if not self.upper_action:
                object.__setattr__(self, "upper_action",
                                   tuple([1.0] * self.dim_action))
            if not self.lower_action:
                object.__setattr__(self, "lower_action",
                                   tuple([-1.0] * self.dim_action))

    # ---------------- dimensions ----------------
    @property
    def is_discrete(self) -> bool:
        return len(self.discrete_values) > 0

    @property
    def dim_state_observed(self) -> int:
        return int(sum(self.observable))

    @property
    def dim_net_input(self) -> int:
        return self.dim_state_observed * (1 + self.n_appended_obs)

    @property
    def max_action_label(self) -> int:
        """Total number of discrete options (StateAction.cpp shifts)."""
        n = 1
        for v in self.discrete_values:
            n *= v
        return n

    @property
    def discrete_shifts(self) -> Tuple[int, ...]:
        """Mixed-radix shifts: shifts[0]=1, shifts[i]=prod(values[:i])."""
        shifts = [1]
        for v in self.discrete_values[:-1]:
            shifts.append(shifts[-1] * v)
        return tuple(shifts)

    @property
    def dim_policy(self) -> int:
        """Size of the stored behavior-policy vector mu.

        Continuous: [means..., stdevs...] (Continuous_policy getVector);
        discrete: probabilities over options (Discrete_policy getVector).
        Reference: MDP.policyVecDim filled by AlgoFactory.cpp:60-340.
        """
        if self.is_discrete:
            return self.max_action_label
        return 2 * self.dim_action

    # ---------------- static numpy views (host) ----------------
    @property
    def action_scale(self) -> np.ndarray:
        """(upper - lower)/2, reference StateAction.h:116-119."""
        return (np.asarray(self.upper_action) -
                np.asarray(self.lower_action)) / 2.0

    @property
    def action_shift(self) -> np.ndarray:
        """(upper + lower)/2, reference StateAction.h:120-122."""
        return (np.asarray(self.upper_action) +
                np.asarray(self.lower_action)) / 2.0

    @property
    def bounded_mask(self) -> np.ndarray:
        return np.asarray(self.bounded, dtype=bool)

    @property
    def observable_mask(self) -> np.ndarray:
        return np.asarray(self.observable, dtype=bool)

    @property
    def state_stats_init(self):
        """(mean, std) over OBSERVED dims from the user state box, or
        None if setStateScales was never called. The reference seeds its
        standardization stats with mean=(u+l)/2, std=|u-l| and replaces
        them once online estimates warm up (Communicator.cpp:98-122,
        StateAction.h:181-203)."""
        if not self.state_upper or not self.state_lower:
            return None
        u = np.asarray(self.state_upper, np.float32)
        l = np.asarray(self.state_lower, np.float32)
        mask = self.observable_mask
        mean = ((u + l) / 2.0)[mask]
        std = np.maximum(np.abs(u - l), 1e-7)[mask]
        return mean, std

    # ---------------- device-side mappings ----------------
    def observed(self, state: jnp.ndarray) -> jnp.ndarray:
        """Select observable dims of a [..., dim_state] state array."""
        idx = np.nonzero(self.observable_mask)[0]
        return jnp.take(state, jnp.asarray(idx), axis=-1)

    def learner_to_env_action(self, learner_act: jnp.ndarray) -> jnp.ndarray:
        """unbounded learner action -> env units.

        Bounded dims: env = scale * tanh(a) + shift; unbounded: scale*a+shift.
        Reference: ActionInfo::learnerAction2envAction (StateAction.h:284-295).
        """
        if self.is_discrete:
            return learner_act
        b = jnp.asarray(self.bounded_mask)
        squashed = jnp.where(b, jnp.tanh(learner_act), learner_act)
        return (jnp.asarray(self.action_scale) * squashed
                + jnp.asarray(self.action_shift))

    def env_to_learner_action(self, env_act: jnp.ndarray) -> jnp.ndarray:
        """env action -> unbounded learner space (atanh for bounded dims).

        Reference: ActionInfo::envAction2learnerAction (StateAction.h:229-245):
        descaled = (env - shift)/scale; learner = atanh(descaled) for bounded,
        (note: the reference applies the atanh to *all* dims; we preserve the
        bounded/unbounded split used by learnerAction2envAction so the two are
        exact inverses).
        """
        if self.is_discrete:
            return env_act
        descaled = ((env_act - jnp.asarray(self.action_shift))
                    / jnp.asarray(self.action_scale))
        b = jnp.asarray(self.bounded_mask)
        return jnp.where(b, jnp.arctanh(jnp.clip(descaled, -1 + 1e-7,
                                                 1 - 1e-7)), descaled)

    def label_to_components(self, label: jnp.ndarray) -> jnp.ndarray:
        """Discrete label -> per-component option indices.

        Reference: ActionInfo::label2actionMessage (StateAction.h:323-341).
        """
        shifts = np.asarray(self.discrete_shifts)
        values = np.asarray(self.discrete_values)
        comps = (label[..., None] // jnp.asarray(shifts)) % jnp.asarray(values)
        return comps

    def components_to_label(self, comps: jnp.ndarray) -> jnp.ndarray:
        """Per-component option indices -> flat label.

        Reference: ActionInfo::actionMessage2label (StateAction.h:305-321).
        """
        shifts = jnp.asarray(np.asarray(self.discrete_shifts))
        return jnp.sum(comps * shifts, axis=-1).astype(jnp.int32)
