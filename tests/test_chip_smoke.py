"""chip_smoke.py rehearsed on the CPU, the compile-cache helper, and the
exact int8 probe product.

chip_smoke.py is the GPU proof; here each of its phases runs in a child
process at a tiny size through `--rehearse`, which reports the CPU
backend it ran on. The default run must refuse a CPU-only JAX.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from turdb_tpu.ops.quantize import int8_dot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _cpu_env(devices: int = 1) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def _run(args, env, cwd=REPO, timeout=600):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("phase,lines", [
    ("oracle", ("phase oracle: ok",)),
    ("ivf_f32", ("phase ivf_f32: ok",)),
    ("ivf_sq8", ("phase ivf_sq8: ok", "phase int8_dot: ok")),
    ("hnsw", ("phase hnsw: ok",)),
    ("sql", ("phase ivf_f32: ok", "phase sql: ok")),
    ("topk", ("phase topk: ok",)),
])
def test_rehearsal_phase(phase, lines):
    r = _run([SMOKE, "--rehearse", "--n", "3000", "--queries", "1300",
              "--phases", phase], _cpu_env())
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for line in ("phase device: ok", *lines):
        assert line in r.stdout, (line, r.stdout[-2000:])
    last = _last_json(r.stdout)
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 1}}


def test_rehearsal_four_cards_on_virtual_devices():
    """The sharded path over a 4-device mesh: shards on 4 distinct
    devices, recall gates against exact search, count 4 in the result."""
    r = _run([SMOKE, "--rehearse", "--four-cards", "--n", "8000",
              "--queries", "1300"], _cpu_env(devices=4))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "devices=[0, 1, 2, 3]" in r.stdout
    for line in ("phase sharded_ivf: ok", "phase sharded_hnsw: ok"):
        assert line in r.stdout
    assert "phase ivf_f32" not in r.stdout     # no one-card phase runs
    last = _last_json(r.stdout)
    assert last["device"]["platform"] == "cpu"
    assert last["device"]["count"] == 4


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_default_run_refuses_cpu_only_jax(script):
    """Measurement paths fail without a GPU; they never fall back."""
    r = _run([os.path.join(REPO, script)], _cpu_env(), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"metric"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_smoke_alone_fails_without_the_repo(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot import the system and must not report a result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = _run([str(tmp_path / "chip_smoke.py")], env, cwd=tmp_path,
             timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

_CACHE_PROBE = (
    "import json, jax\n"
    "import turdb_tpu, turdb_tpu.models.ivf\n"
    "before = jax.config.jax_compilation_cache_dir\n"
    "from turdb_tpu.utils.compile_cache import DEFAULT_DIR, use_compile_cache\n"
    "got = use_compile_cache()\n"
    "print(json.dumps([before, got, jax.config.jax_compilation_cache_dir,"
    " DEFAULT_DIR]))\n"
)


def test_compile_cache_env_var_wins(tmp_path):
    env = _cpu_env()
    want = str(tmp_path / "cache")
    env["JAX_COMPILATION_CACHE_DIR"] = want
    r = _run(["-c", _CACHE_PROBE], env, timeout=120)
    assert r.returncode == 0, r.stderr[-1000:]
    before, got, after, _ = _last_json(r.stdout)
    assert before == want       # JAX took it from the environment
    assert got == want and after == want


def test_compile_cache_default_is_fixed_checkout_path():
    r = _run(["-c", _CACHE_PROBE], _cpu_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-1000:]
    before, got, after, default = _last_json(r.stdout)
    assert before is None       # importing the package sets nothing
    assert default == os.path.join(REPO, ".jax_cache")
    assert got == default and after == default


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---------------------------------------------------------------------------
# int8 probe product: s8 x s8 -> s32 must equal numpy int32 exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (4, 3, 16, 128),     # IVF probe [B, P, L, d]
    (2, 4, 32, 96),      # HNSW beam [B, E, deg, d]
    (3, 5, 7),           # one lane axis, odd widths
])
def test_int8_dot_exact_vs_numpy(shape):
    rng = np.random.default_rng(len(shape))
    qc = rng.integers(-128, 128, size=(shape[0], shape[-1]), dtype=np.int8)
    codes = rng.integers(-128, 128, size=shape, dtype=np.int8)
    got = np.asarray(jax.jit(int8_dot)(jnp.asarray(qc), jnp.asarray(codes)))
    want = np.einsum("bd,b...d->b...", qc.astype(np.int32),
                     codes.astype(np.int32))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_int8_dot_extremes_do_not_overflow():
    """All -128 x -128 at d=128 is the largest sum the probe can see."""
    d = 128
    qc = jnp.full((2, d), -128, jnp.int8)
    codes = jnp.full((2, 3, d), -128, jnp.int8)
    got = np.asarray(int8_dot(qc, codes))
    assert (got == 128 * 128 * d).all()
