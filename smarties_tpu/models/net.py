"""Function approximators: MLP / LSTM / GRU stacks with a param head.

JAX replacement of the reference's hand-written NN library
(source/smarties/Network/{Network,Builder}.{h,cpp}, Layers/*): layers become
batched jnp matmuls under jit instead of per-sample GEMV
(Layers.h:33-61 GEMVomp); BPTT becomes lax.scan over time.

Init conventions follow the reference exactly:
- weights ~ U(-f, f) with f = initializationFac * act.initFactor(nIn, nOut)
  (Layer_Base.h:115-141); initFactor per activation from Functions.h
  (SoftSign/Tanh: sqrt(6/(in+out)); Relu/SoftPlus/Exp: sqrt(2/in);
  Linear: sqrt(1/in));
- biases zero, except explicit bias init via the activation inverse
  (Layer_Base.h:122-125);
- the output layer is Linear with initializationFac = outWeightsPrefac
  (default 0.1, Builder.cpp / HyperParameters);
- a trainable state-independent ParamLayer appends extra outputs (used for
  the policy stdev head, RACER_common.cpp:96-103).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------- activations (Functions.h) ----------------

def _soft_sign(x):
    return x / (1 + jnp.abs(x))


def _safe_exp(x):
    """Clipped exp (Utilities::safeExp: clamp to [exp(-32), exp(16)])."""
    return jnp.exp(jnp.clip(x, -32.0, 16.0))


_ACTS = {
    "Linear": lambda x: x,
    "Tanh": jnp.tanh,
    "Sigm": jax.nn.sigmoid,
    "SoftSign": _soft_sign,
    "Relu": jax.nn.relu,
    "LRelu": lambda x: jnp.where(x > 0, x, 0.01 * x),
    "SoftPlus": lambda x: (x + jnp.sqrt(1 + x * x)) / 2,
    "Exp": jnp.exp,
    "HardSign": lambda x: x / jnp.sqrt(1 + x * x),
    # Functions.h:255-295 HardSigmoid, :364-395 SoftRBF, :493-525 ExpPlus
    "HardSigmoid": lambda x: 0.5 * (1 + x / jnp.sqrt(1 + x * x)),
    "SoftRBF": lambda x: 1.0 / (1 + x * x),
    "ExpPlus": lambda x: jnp.log1p(_safe_exp(x)),
}

_INIT_FACTOR = {
    # Functions.h _initFactor per activation
    "Linear": lambda i, o: np.sqrt(1.0 / i),
    "Tanh": lambda i, o: np.sqrt(6.0 / (i + o)),
    "Sigm": lambda i, o: np.sqrt(6.0 / (i + o)),
    "SoftSign": lambda i, o: np.sqrt(6.0 / (i + o)),
    "HardSign": lambda i, o: np.sqrt(6.0 / (i + o)),
    "HardSigmoid": lambda i, o: np.sqrt(6.0 / (i + o)),
    "SoftRBF": lambda i, o: np.sqrt(6.0 / (i + o)),
    "Relu": lambda i, o: np.sqrt(2.0 / i),
    "LRelu": lambda i, o: np.sqrt(1.0 / i),
    "SoftPlus": lambda i, o: np.sqrt(2.0 / i),
    "ExpPlus": lambda i, o: np.sqrt(2.0 / i),
    "Exp": lambda i, o: np.sqrt(2.0 / i),
}

# activation inverses for bias init "so that the initial output equals the
# requested value" (Layer_Base.h:122-125: biases[o] = func->inverse(init))
_INVERSE = {
    "Linear": lambda y: y,
    "Tanh": np.arctanh,
    "Sigm": lambda y: np.log(y / (1 - y)),
    "SoftSign": lambda y: y / (1 - np.abs(y)),
    "HardSign": lambda y: y / np.sqrt(1 - y * y),
    "HardSigmoid": lambda y: (2 * y - 1) / np.sqrt(1 - (2 * y - 1) ** 2),
    "SoftPlus": lambda y: y - 1.0 / (4 * y),
    "ExpPlus": lambda y: np.log(np.exp(y) - 1),
    "Exp": np.log,
    "Relu": lambda y: y,
    "LRelu": lambda y: y,
    "SoftRBF": lambda y: np.sqrt(1.0 / y - 1.0),
}


def activation(name: str):
    return _ACTS[name]


def join(*xs):
    """JoinLayer analog (Network/Layers/Layers.h JoinLayer): multiple
    input streams are concatenated on the feature axis. Aux-input
    composition (e.g. the DPG critic's action input) uses this."""
    return jnp.concatenate(xs, axis=-1)


@dataclass(frozen=True)
class Conv2DDesc:
    """One conv layer (reference: Conv2D_Descriptor, Definitions.h:60-69,
    set by Communicator::setPreprocessingConv2d). Valid padding, square
    filters/strides, as in the reference Conv2DLayer."""
    in_w: int
    in_h: int
    in_c: int
    out_c: int
    filter: int
    stride: int

    @property
    def out_w(self) -> int:
        return (self.in_w - self.filter) // self.stride + 1

    @property
    def out_h(self) -> int:
        return (self.in_h - self.filter) // self.stride + 1


def _s2d_stride(c0: "Conv2DDesc") -> int:
    """Stride s when the FIRST conv layer runs as a space-to-depth
    stride-1 conv (blocked s*s*in_c input channels), else 0.

    Applicability: strided, filter and image divisible by the stride,
    and a small input depth (a shallow contraction for a matrix unit —
    e.g. the Mnih 8x8/4 conv over 4 stacked frames becomes a 2x2/1 conv
    over 64 channels). Opt out with SMT_NO_S2D=1 (bit-compat with
    pre-r5 artifacts; the transform is numerically equivalent, not
    bitwise).
    """
    import os
    if os.environ.get("SMT_NO_S2D"):
        return 0
    s = c0.stride
    if (s > 1 and c0.filter % s == 0 and c0.in_h % s == 0
            and c0.in_w % s == 0 and c0.in_c <= 8):
        return s
    return 0


@dataclass(frozen=True)
class NetSpec:
    """Static architecture description (reference: Builder.cpp:27-180)."""
    n_in: int
    hidden: Tuple[int, ...] = (128, 128)
    n_out: int = 1
    kind: str = "FFNN"              # FFNN | LSTM | GRU (nnType)
    act: str = "SoftSign"           # nnFunc
    out_act: str = "Linear"         # nnOutputFunc
    out_prefac: float = 0.1         # outWeightsPrefac
    n_param_out: int = 0            # trainable param head size (stdev)
    param_init: Tuple[float, ...] = ()   # raw bias init of the param head
    out_bias_init: Tuple[float, ...] = ()
    # skip connections between equal-width FFNN hidden layers
    # (ResidualLayer, Network/Layers/Layers.h:421-470: the layer's output
    # is summed with the previous layer's output)
    residual: bool = False
    # conv preprocessing stack applied to the (flattened-image) input
    # before the dense layers (Builder::addConv2d, Conv2Dfactory.h)
    conv: Tuple[Conv2DDesc, ...] = ()
    # matmul/conv compute dtype: "bfloat16" runs the contractions in
    # bf16 with f32 accumulation (the reference's nnReal f32/f64 switch,
    # Definitions.h:21-57, maps to this choice); parameters, activations
    # and reductions stay f32
    compute_dtype: str = "float32"

    @property
    def total_out(self) -> int:
        return self.n_out + self.n_param_out

    @property
    def is_recurrent(self) -> bool:
        return self.kind in ("LSTM", "GRU", "RNN")


def _uniform(key, shape, fac):
    return jax.random.uniform(key, shape, jnp.float32, -fac, fac)


def _mlp_in_dim(spec: NetSpec) -> int:
    """Dense-stack input size: conv output if a conv stack is present."""
    if spec.conv:
        c = spec.conv[-1]
        return c.out_w * c.out_h * c.out_c
    return spec.n_in


def init_params(key, spec: NetSpec) -> Dict:
    """Build the parameter pytree."""
    params = {"layers": [], "out": {}, }
    if spec.conv:
        kc = jax.random.fold_in(key, 999)
        params["conv"] = []
        for ci, c in enumerate(spec.conv):
            fan_in = c.filter * c.filter * c.in_c
            fac = _INIT_FACTOR["Relu"](fan_in, c.out_c)
            params["conv"].append({
                "W": _uniform(jax.random.fold_in(kc, ci),
                              (c.filter, c.filter, c.in_c, c.out_c), fac),
                "b": jnp.zeros((c.out_c,), jnp.float32)})
    sizes = [_mlp_in_dim(spec)] + list(spec.hidden)
    keys = jax.random.split(key, len(spec.hidden) + 2)
    for li, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        k = keys[li]
        if spec.kind == "FFNN" or spec.kind == "RNN":
            fac = _INIT_FACTOR[spec.act](nin, nout)
            layer = {"W": _uniform(k, (nin, nout), fac),
                     "b": jnp.zeros((nout,), jnp.float32)}
            if spec.kind == "RNN":
                layer["R"] = _uniform(jax.random.fold_in(k, 1),
                                      (nout, nout), fac)
        elif spec.kind == "LSTM":
            # 4 gates: input-mod (Tanh-like) + 3 sigmoid gates
            # (Layer_LSTM.h); glorot per gate
            fac_c = _INIT_FACTOR["Tanh"](nin, nout)
            fac_g = _INIT_FACTOR["Sigm"](nin, nout)
            ks = jax.random.split(k, 8)
            layer = {
                "Wc": _uniform(ks[0], (nin, nout), fac_c),
                "Wi": _uniform(ks[1], (nin, nout), fac_g),
                "Wf": _uniform(ks[2], (nin, nout), fac_g),
                "Wo": _uniform(ks[3], (nin, nout), fac_g),
                "Rc": _uniform(ks[4], (nout, nout), fac_c),
                "Ri": _uniform(ks[5], (nout, nout), fac_g),
                "Rf": _uniform(ks[6], (nout, nout), fac_g),
                "Ro": _uniform(ks[7], (nout, nout), fac_g),
                "bc": jnp.zeros((nout,), jnp.float32),
                "bi": jnp.zeros((nout,), jnp.float32),
                # forget-gate bias primed to 1 (standard; the reference zeroes
                # it only in finite-difference test builds, Bund.h:62-67)
                "bf": jnp.ones((nout,), jnp.float32),
                "bo": jnp.zeros((nout,), jnp.float32),
            }
        elif spec.kind == "GRU":
            # MGU (minimal gated unit) as in Layer_GRU.h
            fac_c = _INIT_FACTOR["Tanh"](nin, nout)
            fac_g = _INIT_FACTOR["Sigm"](nin, nout)
            ks = jax.random.split(k, 4)
            layer = {
                "Wf": _uniform(ks[0], (nin, nout), fac_g),
                "Rf": _uniform(ks[1], (nout, nout), fac_g),
                "Wh": _uniform(ks[2], (nin, nout), fac_c),
                "Rh": _uniform(ks[3], (nout, nout), fac_c),
                "bf": jnp.zeros((nout,), jnp.float32),
                "bh": jnp.zeros((nout,), jnp.float32),
            }
        else:
            raise ValueError(spec.kind)
        params["layers"].append(layer)

    # output layer: Linear, prefac-scaled init (Builder setLastLayersBias)
    nin = sizes[-1]
    fac = spec.out_prefac * _INIT_FACTOR[spec.out_act](nin, spec.n_out)
    bias = jnp.zeros((spec.n_out,), jnp.float32)
    if spec.out_bias_init:
        # bias through the activation inverse so the initial post-
        # activation output equals the requested value (Layer_Base.h:122-125)
        bias = jnp.asarray(
            _INVERSE[spec.out_act](np.asarray(spec.out_bias_init,
                                              np.float64)), jnp.float32)
    params["out"] = {"W": _uniform(keys[-2], (nin, spec.n_out), fac),
                     "b": bias}
    if spec.n_param_out:
        pinit = (jnp.asarray(spec.param_init, jnp.float32)
                 if spec.param_init else
                 jnp.zeros((spec.n_param_out,), jnp.float32))
        params["param"] = pinit
    return params


def init_carry(spec: NetSpec, batch_shape=()):
    """Zero recurrent state (AgentContext analog, ThreadContext.h)."""
    if not spec.is_recurrent:
        return ()
    carries = []
    for h in spec.hidden:
        if spec.kind == "LSTM":
            carries.append((jnp.zeros(batch_shape + (h,), jnp.float32),
                            jnp.zeros(batch_shape + (h,), jnp.float32)))
        else:
            carries.append(jnp.zeros(batch_shape + (h,), jnp.float32))
    return tuple(carries)


def apply_net(params: Dict, spec: NetSpec, x, carry=()):
    """Forward pass. x: [..., n_in]. Returns (y [..., total_out], new_carry).

    Batched over leading axes; recurrent carries must share those axes.
    """
    act = _ACTS[spec.act]
    cdt = jnp.bfloat16 if spec.compute_dtype == "bfloat16" else None

    def mm(a, w):
        """Contraction in the compute dtype; explicit upcast so the VJP
        recasts cotangents instead of mixing dtypes."""
        if cdt is None:
            return a @ w
        return (a.astype(cdt) @ w.astype(cdt)).astype(jnp.float32)

    h = x
    if spec.conv:
        c0 = spec.conv[0]
        s2d = _s2d_stride(c0)
        if cdt is not None:
            # bf16 recipes cast BEFORE the reshape/transpose below:
            # the conv-input tensor is the largest in the step and the
            # transpose traffic halves (with f32 the cast sits inside
            # the conv loop and the transpose moves f32 bytes)
            h = h.astype(cdt)
        if h.ndim == 4 and h.shape[1:] == (c0.in_h, c0.in_w, c0.in_c):
            # pre-shaped NHWC input (gather_minibatch nhwc_hw path):
            # skip the flat-input reshape + CHW->NHWC transpose
            lead = h.shape[:1]
            if s2d:
                s = s2d
                h = h.reshape((-1, c0.in_h // s, s, c0.in_w // s, s,
                               c0.in_c))
                h = jnp.transpose(h, (0, 1, 3, 2, 4, 5)).reshape(
                    (-1, c0.in_h // s, c0.in_w // s, s * s * c0.in_c))
        else:
            lead = h.shape[:-1]
            # flattened input is [frame0; frame1; ...] (appended past
            # obs, Episode::standardizedState) == CHW; convert to NHWC
            if s2d:
                # straight to the space-to-depth block layout in ONE
                # transpose (channel order (p, q, c) matches the weight
                # transform below)
                s = s2d
                h = h.reshape((-1, c0.in_c, c0.in_h // s, s,
                               c0.in_w // s, s))
                h = jnp.transpose(h, (0, 2, 4, 3, 5, 1)).reshape(
                    (-1, c0.in_h // s, c0.in_w // s, s * s * c0.in_c))
            else:
                h = h.reshape((-1, c0.in_c, c0.in_h, c0.in_w))
                h = jnp.transpose(h, (0, 2, 3, 1))
        for ci, (layer, c) in enumerate(zip(params["conv"], spec.conv)):
            w = layer["W"].astype(cdt) if cdt is not None else layer["W"]
            if ci == 0 and s2d:
                # space-to-depth (MLPerf-style): an [K,K,Cin,O] stride-s
                # conv over tiny Cin is a shallow contraction; re-express
                # it EXACTLY as a [K/s,K/s,s*s*Cin,O] stride-1 conv over
                # s*s-deep blocked pixels. Same index set, summed in a
                # different order -> numerically equivalent (not bitwise);
                # parameters stay in the reference [K,K,Cin,O] layout
                # (checkpoint compat), transformed at trace time (tiny).
                s = s2d
                w = w.reshape((c.filter // s, s, c.filter // s, s,
                               c.in_c, c.out_c))
                w = jnp.transpose(w, (0, 2, 1, 3, 4, 5)).reshape(
                    (c.filter // s, c.filter // s, s * s * c.in_c,
                     c.out_c))
                stride = (1, 1)
            else:
                stride = (c.stride, c.stride)
            # NOTE: pure-bf16 conv + explicit upcast (not
            # preferred_element_type): the conv transpose in the VJP
            # would otherwise pair an f32 cotangent with bf16 kernels
            # and fail; the astype's backward recasts the cotangent.
            h = jax.lax.conv_general_dilated(
                h.astype(cdt) if cdt is not None else h, w,
                stride, "VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            h = _ACTS["LRelu"](h.astype(jnp.float32) + layer["b"])
        h = h.reshape(lead + (-1,))
    new_carry = []
    for li, layer in enumerate(params["layers"]):
        if spec.kind == "FFNN":
            h_new = act(mm(h, layer["W"]) + layer["b"])
            # residual sum when widths match (ResidualLayer, Layers.h:421)
            if spec.residual and h_new.shape[-1] == h.shape[-1]:
                h_new = h_new + h
            h = h_new
        elif spec.kind == "RNN":
            prev = carry[li]
            h = act(h @ layer["W"] + prev @ layer["R"] + layer["b"])
            new_carry.append(h)
        elif spec.kind == "LSTM":
            hprev, cprev = carry[li]
            zc = jnp.tanh(h @ layer["Wc"] + hprev @ layer["Rc"] + layer["bc"])
            zi = jax.nn.sigmoid(h @ layer["Wi"] + hprev @ layer["Ri"]
                                + layer["bi"])
            zf = jax.nn.sigmoid(h @ layer["Wf"] + hprev @ layer["Rf"]
                                + layer["bf"])
            zo = jax.nn.sigmoid(h @ layer["Wo"] + hprev @ layer["Ro"]
                                + layer["bo"])
            c = zf * cprev + zi * zc
            h = zo * jnp.tanh(c)
            new_carry.append((h, c))
        elif spec.kind == "GRU":
            hprev = carry[li]
            f = jax.nn.sigmoid(h @ layer["Wf"] + hprev @ layer["Rf"]
                               + layer["bf"])
            hh = jnp.tanh(h @ layer["Wh"] + (f * hprev) @ layer["Rh"]
                          + layer["bh"])
            h = (1 - f) * hprev + f * hh
            new_carry.append(h)
    y = _ACTS[spec.out_act](mm(h, params["out"]["W"])
                            + params["out"]["b"])
    if spec.n_param_out:
        p = jnp.broadcast_to(params["param"], y.shape[:-1]
                             + (spec.n_param_out,))
        y = jnp.concatenate([y, p], axis=-1)
    return y, tuple(new_carry)


def apply_net_seq(params: Dict, spec: NetSpec, xs, carry):
    """Run a time sequence with lax.scan (BPTT path).

    xs: [T, ..., n_in]; carry batched over the non-time axes.
    Returns (ys [T, ..., total_out], final_carry).
    """
    def step(c, x):
        y, c2 = apply_net(params, spec, x, c)
        return c2, y

    final, ys = jax.lax.scan(step, carry, xs)
    return ys, final
