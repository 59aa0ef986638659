"""smarties_tpu — a JAX actor-learner deep-RL framework for one accelerator.

A from-scratch JAX/XLA re-design of the capabilities of cselab/smarties
(C++14/MPI ReF-ER actor-learner framework, Novati & Koumoutsakos ICML 2019):
V-RACER / RACER / PPO / DQN / DPG / NAF / ACER / CMA-ES learners on top of a
Remember-and-Forget experience-replay core, re-expressed for an accelerator:

- one jitted train step and one jitted act step instead of threads/sockets/MPI
  (reference: source/smarties/Core/{Master,Worker}.cpp);
- an on-device episode-slotted replay ring with masked segment scans for
  Retrace / ReF-ER bookkeeping (reference: source/smarties/ReplayMemory/);
- GSPMD (jax.sharding.Mesh + jit shardings) for data/population parallelism
  (reference: MPI Iallreduce in source/smarties/Network/Optimizer.cpp);
- counter-based PRNG (jax.random) replacing Saru (reference: extern/saruprng.h).
"""

__version__ = "0.1.0"

from smarties_tpu.utils.config import HyperParameters
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.runtime.engine import Engine
from smarties_tpu.runtime.communicator import Communicator
