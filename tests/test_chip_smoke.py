"""chip_smoke.py and bench.py: their phases at tiny sizes on the CPU, the
refusal to run without a GPU, the compile-cache helper, and the on-card
checks (marked `gpu`)."""
import json
import os

import jax
import numpy as np
import pytest

import bench
import chip_smoke as cs
from smarties_tpu.utils import compile_cache, harness

TINY = dict(n_envs=16, n_slots=64, batch=32, min_tot=512, max_tot=4096)


@pytest.fixture(scope="module")
def tiny_trainer():
    return cs.phase_fused(cycles=2, **TINY)


def test_phase_fused_advances_ledger(tiny_trainer):
    tr = tiny_trainer
    assert tr.n_grad_steps == 2 * TINY["n_envs"]
    assert np.isfinite(np.asarray(tr.replay.qret)).all()


def test_phase_retrace_matches_float64(tiny_trainer):
    cs.phase_retrace(E=45, L=20, tr=tiny_trainer)


def test_phase_atari_and_cpu_parity(tiny_trainer):
    cs.phase_atari(tr=tiny_trainer, Q=2, E=8, L=8, image=36, batch=8)


def test_phase_launcher(tmp_path, monkeypatch):
    # the launcher enables the compile cache: keep it out of the checkout
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    recipe = tmp_path / "tiny.json"
    recipe.write_text(json.dumps({
        "learner": "VRACER", "nnLayerSizes": [16], "batchSize": 16,
        "minTotObsNum": 256, "maxTotObsNum": 2048}))
    # the warmup overshoots minTotObsNum by 256 env steps: 600 grad steps
    # run past them into the rollout/train alternation
    cs.phase_launcher(n_envs=16, steps=600, runprefix=str(tmp_path),
                      recipe=str(recipe))
    run = tmp_path / "chip_smoke_launcher"
    assert (run / "settings.json").exists()
    assert (run / "checkpoint.pkl").exists()


def test_phase_engine_forked_workers(tmp_path):
    cs.phase_engine(n_workers=2, steps=50, limit_s=300,
                    run_dir=str(tmp_path / "engine"))


def test_phase_four_on_virtual_devices():
    cs.phase_four(n_envs=16, n_slots=64, steps=1000, batch=32,
                  min_tot=512, max_tot=4096)


def test_main_refuses_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_peaks_unknown_kind_is_an_error():
    assert bench.peaks_for("NVIDIA H100 80GB HBM3")["tf32"] == 495e12
    with pytest.raises(KeyError):
        bench.peaks_for("cpu")


def test_atari_flops_from_shapes():
    algo, _, _ = harness.build_atari(1, E=4, L=4, batch=8, image=36)
    # 36x36x4 -> 8x8x32 (8/4) -> 3x3x64 (4/2) -> 1x1x64 (3/1) -> 512 -> out
    conv1 = 8 * 8 * 8 * 8 * 4 * 32
    macs = (conv1 + 3 * 3 * 4 * 4 * 32 * 64 + 1 * 1 * 3 * 3 * 64 * 64
            + 64 * 512 + 512 * algo.spec.n_out)
    # forward over 2B rows, weight and input gradients over B rows, no
    # input gradient of the first conv
    assert bench.atari_flops_per_step(algo.spec, 8) == \
        (8 * macs - 2 * conv1) * 8


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert compile_cache.enable_compile_cache() == \
                compile_cache.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == \
                compile_cache.DEFAULT_DIR
            assert compile_cache.DEFAULT_DIR == os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(
                    __file__))), ".jax_cache")
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            jax.config.update("jax_compilation_cache_dir", None)
            assert compile_cache.enable_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.gpu
def test_retrace_sweep_on_card(gpu):
    with jax.default_device(gpu):
        cs.phase_retrace()


@pytest.mark.gpu
def test_grad_parity_on_card(gpu):
    n = len(jax.devices("gpu"))
    if n < 2:
        pytest.skip("needs two or more GPUs")
    k = 4 if n >= 4 else 2
    p1, pk = harness.grad_parity(k)
    for a, b in zip(p1, pk):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
