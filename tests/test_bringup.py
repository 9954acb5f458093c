"""What decides where the solver runs: backend resolution, the compile
cache directory, the mesh builder, the entry points' GPU checks, and the
independent incumbent checker of chip_smoke.py."""

import itertools
import json
import sys
from math import comb

import numpy as np
import pytest

import scipsdp_tpu
from scipsdp_tpu.models.families import cardinality_least_squares, cls_data
from scipsdp_tpu.utils import config as cfg
from scipsdp_tpu.utils.config import IPMSettings, Settings

from conftest import REPO, load_root_module


# ------------------------------------------------------------- backends

@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_backend_autos_resolve_to_plain_f64(backend, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    ipm = cfg.resolve_backend_autos(Settings()).ipm
    assert (ipm.step_rule, ipm.phase32) == (
        cfg.BACKEND_AUTOS[backend]["step_rule"],
        cfg.BACKEND_AUTOS[backend]["phase32"])
    assert "auto" not in (ipm.step_rule, ipm.phase32)


def test_backend_autos_unknown_backend_raises(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported jax backend"):
        cfg.resolve_backend_autos(Settings())


def test_backend_autos_keep_explicit_settings(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    s = Settings(ipm=IPMSettings(step_rule="probe", phase32="refine"))
    assert cfg.resolve_backend_autos(s) is s


# --------------------------------------------------------- compile cache

def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert scipsdp_tpu.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert scipsdp_tpu.compilation_cache_dir() == \
        f"{REPO}/.jax_cache"


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_cache_sets_dir_only_without_env(env_set, monkeypatch,
                                                tmp_path):
    import jax

    calls, made = [], []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(scipsdp_tpu._os, "makedirs",
                        lambda p, exist_ok=False: made.append(p))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = scipsdp_tpu.enable_compilation_cache()
    keys = dict(calls)
    if env_set:
        assert got == str(tmp_path)
        assert "jax_compilation_cache_dir" not in keys and not made
    else:
        assert got == made[0] == keys["jax_compilation_cache_dir"]
        assert got.endswith(".jax_cache")


# ------------------------------------------------------------------ mesh

class _FakeDevice:
    platform = "gpu"
    id = 0


def test_make_mesh_too_few_gpus_raises(monkeypatch):
    import scipsdp_tpu.parallel.mesh as mesh_mod

    monkeypatch.setattr(mesh_mod.jax, "local_devices",
                        lambda *a, **k: [_FakeDevice()])
    with pytest.raises(ValueError, match="have 1 gpu") as e:
        mesh_mod.make_mesh(4)
    assert "xla_force_host_platform_device_count" not in str(e.value)


def test_make_mesh_too_few_cpus_hints_virtual_devices():
    from scipsdp_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError,
                       match="xla_force_host_platform_device_count=64"):
        make_mesh(64)


# ----------------------------------------------------- entry points, no GPU

def test_cli_requires_gpu_or_cpu_flag(capsys):
    from scipsdp_tpu.__main__ import main

    assert main(["missing.dat-s"]) == 2
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.parametrize("script", ["bench", "bench_relax",
                                    "bench_families", "profile_h100"])
def test_bench_scripts_refuse_cpu(script, monkeypatch, capsys):
    mod = load_root_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py"])
    if script == "profile_h100":
        with pytest.raises(SystemExit, match="needs a GPU"):
            mod.main(["trace"])
        return
    try:
        rc = mod.main()
    except SystemExit as e:
        rc = e.code
    assert rc not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_chip_smoke_fails_without_gpu(chip_smoke, capsys):
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "not 'gpu'" in err
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


# ----------------------------------------- chip_smoke's independent checks

CLS = (6, 12, 3)


def _optimal_point(chip_smoke, seed=0):
    A, b = cls_data(*CLS, seed)
    t, support, _ = chip_smoke.cls_enumerate(A, b, CLS[2])
    _, xs = chip_smoke.support_lstsq(A, b, list(support))
    n = CLS[0]
    y = np.zeros(2 * n + 1)
    y[list(support)] = xs
    y[n + np.asarray(support, int)] = 1.0
    y[2 * n] = t
    return cardinality_least_squares(*CLS, seed=seed), A, b, y, t, support


def test_checker_accepts_the_optimum(chip_smoke):
    prob, A, b, y, t, _ = _optimal_point(chip_smoke)
    assert chip_smoke.check_cls_incumbent(prob, A, b, y, t) == []


def _fractional_z(y, t, s, n):
    y[n + s[0]] = 0.5


def _x_off_support(y, t, s, n):
    y[[j for j in range(n) if j not in s][0]] = 0.1


def _too_many_z(y, t, s, n):
    y[n:2 * n] = 1.0


def _t_too_low(y, t, s, n):
    y[2 * n] = 0.9 * t


def _x_shifted(y, t, s, n):
    y[s[0]] += 0.05


def _x_out_of_box(y, t, s, n):
    y[s[0]] = 11.0


@pytest.mark.parametrize("perturb", [_fractional_z, _x_off_support,
                                     _too_many_z, _t_too_low, _x_shifted,
                                     _x_out_of_box])
def test_checker_rejects_perturbed_points(perturb, chip_smoke):
    prob, A, b, y, t, s = _optimal_point(chip_smoke)
    perturb(y, t, list(s), CLS[0])
    assert chip_smoke.check_cls_incumbent(prob, A, b, y, y[-1]) != []


def test_checker_rejects_a_wrong_objective(chip_smoke):
    prob, A, b, y, t, _ = _optimal_point(chip_smoke)
    assert chip_smoke.check_cls_incumbent(prob, A, b, y, 1.01 * t) != []


def test_enumeration_counts_every_support(chip_smoke):
    A, b = cls_data(14, 28, 5, 3)
    t, support, count = chip_smoke.cls_enumerate(A, b, 5)
    assert count == sum(comb(14, r) for r in range(6)) == 3473
    # no support of size <= 5 fits better than the reported one
    best = min(chip_smoke.support_lstsq(A, b, list(s))[0]
               for r in range(6)
               for s in itertools.combinations(range(14), r))
    assert t == best and len(support) <= 5


@pytest.mark.gpu
def test_gpu_relaxation_matches_cpu(gpu, chip_smoke):
    """One batched relaxation solve on the card against the same solve on
    the CPU in f64 (chip_smoke's parity phase at a small shape)."""
    prob = cardinality_least_squares(*CLS, seed=0)
    out = chip_smoke.parity_phase("cls_6", prob, B=8)
    assert out["max_rel_dobj_diff"] <= chip_smoke.PARITY_RTOL
