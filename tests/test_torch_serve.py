"""Port's serving path held against the JAX package (prefill, decode,
greedy generation on converted parameters) and against its own
teacher-forced forward; entry points refuse to run without CUDA unless the
CPU is asked for."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models.lm import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import make_decode_fn as jax_make_decode_fn
from repro.serve.engine import make_prefill_fn as jax_make_prefill_fn
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models.lm import forward, init_params
from repro_torch.serve.engine import (Engine, make_decode_fn, make_prefill_fn,
                                      resolve_device)

ARCH = "llama3.2-1b"
MAMBA_ARCH = "falcon-mamba-7b"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
# the serve twins run the llama variants and the reduced falcon-mamba-7b
ARCHS = {"mha": ARCH, "gqa": ARCH, "mamba": MAMBA_ARCH}


def _setup(variant, seed):
    kw = VARIANTS.get(variant, {})
    jcfg = jax_get_reduced(ARCHS[variant]).replace(**kw)
    cfg = get_reduced(ARCHS[variant]).replace(**kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _jax_serve(jcfg, jp, toks, S0, n_dec, cache_len, window_override=0):
    prefill = jax_make_prefill_fn(jcfg, cache_len=cache_len,
                                  window_override=window_override)
    decode = jax_make_decode_fn(jcfg, window_override=window_override)
    st = prefill(jp, jnp.asarray(toks[:, :S0], jnp.int32))
    cache, logits = st["cache"], [np.asarray(st["logits_last"])]
    for i in range(n_dec):
        out = decode(jp, cache, jnp.asarray(toks[:, S0 + i:S0 + i + 1], jnp.int32),
                     jnp.asarray(S0 + i, jnp.int32))
        logits.append(np.asarray(out["logits"]))
        cache = out["cache"]
    return logits


def _port_serve(cfg, tp, toks, S0, n_dec, cache_len, window_override=0):
    prefill = make_prefill_fn(cfg, cache_len=cache_len,
                              window_override=window_override)
    decode = make_decode_fn(cfg, window_override=window_override)
    t = torch.from_numpy(toks)
    st = prefill(tp, t[:, :S0])
    cache, logits = st["cache"], [st["logits_last"].numpy()]
    for i in range(n_dec):
        out = decode(tp, cache, t[:, S0 + i:S0 + i + 1], S0 + i)
        logits.append(out["logits"].numpy())
        cache = out["cache"]
    return logits


@pytest.mark.parametrize("variant", sorted(ARCHS))
def test_prefill_and_decode_match_jax(variant):
    jcfg, cfg, jp, tp = _setup(variant, 1)
    B, S, S0 = 2, 32, 26
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want = _jax_serve(jcfg, jp, toks, S0, 6, S)
    got = _port_serve(cfg, tp, toks, S0, 6, S)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"step {i}")


def test_ring_window_decode_matches_jax():
    """window_override 16 with a prompt past the window: prefill rolls the
    cache into a ring, decode wraps and evicts."""
    jcfg, cfg, jp, tp = _setup("gqa", 5)
    S, S0 = 40, 20
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, S))
    want = _jax_serve(jcfg, jp, toks, S0, S - S0, S, window_override=16)
    got = _port_serve(cfg, tp, toks, S0, S - S0, S, window_override=16)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"step {i}")


@pytest.mark.parametrize("window_override", [0, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_own_teacher_forcing(variant, window_override):
    """Kernel-path prefill + cached decode against a plain teacher-forced
    forward, at tests/test_serve.py's 2e-3."""
    cfg = get_reduced(ARCH).replace(**VARIANTS[variant])
    tp = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    B, S, S0 = 2, 40, 30
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    full = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain",
                   window_override=window_override)["logits"].numpy()
    got = _port_serve(cfg, tp, toks, S0, S - S0, S, window_override)
    errs = [float(np.abs(full[:, S0 - 1 + i] - g).max()) for i, g in enumerate(got)]
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("variant", sorted(ARCHS))
def test_greedy_tokens_equal_jax_engine(variant):
    jcfg, cfg, jp, tp = _setup(variant, 0)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 8))
    want = JaxEngine(jcfg, jp, max_len=64).generate(
        jnp.asarray(prompts, jnp.int32), max_new_tokens=8)
    got = Engine(cfg, tp, max_len=64, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba_decode_matches_own_teacher_forcing():
    """Kernel-path prefill + recurrent decode against a teacher-forced
    forward (tests/test_serve.py:24 for the arch), at its 2e-3."""
    cfg = get_reduced(MAMBA_ARCH)
    tp = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    B, S, S0 = 2, 32, 26
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    full = forward(tp, torch.from_numpy(toks), cfg)["logits"].numpy()
    got = _port_serve(cfg, tp, toks, S0, S - S0, S)
    errs = [float(np.abs(full[:, S0 - 1 + i] - g).max()) for i, g in enumerate(got)]
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch", [ARCH, MAMBA_ARCH])
def test_generate_returns_int32_as_the_reference(arch):
    cfg = get_reduced(arch)
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    eng = Engine(cfg, tp, max_len=32, device="cpu")
    assert eng.generate(prompts, 4).dtype == torch.int32
    assert eng.generate(prompts, 4, temperature=0.8,
                        generator=torch.Generator().manual_seed(3)).dtype == torch.int32


def test_temperature_sampling_follows_the_generator():
    cfg = get_reduced(ARCH)
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, tp, max_len=32, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    a, b, c = (eng.generate(prompts, 6, temperature=0.8,
                            generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert a.shape == (2, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_engine_rejects_prompts_past_max_len():
    cfg = get_reduced(ARCH)
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, tp, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.generate(torch.zeros((1, 12), dtype=torch.long), 8)


def test_cli_serves_on_cpu_when_asked(capsys):
    out = serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                          "--max-new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "[serve] llama3.2-1b on cpu" in capsys.readouterr().out


def test_cli_serves_mamba_on_cpu(capsys):
    out = serve_cli.main(["--arch", MAMBA_ARCH, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--max-new", "4"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert f"[serve] {MAMBA_ARCH} on cpu" in capsys.readouterr().out


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_engine_raises_without_cuda_unless_cpu_asked(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = get_reduced(ARCH)
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, tp)
    Engine(cfg, tp, device="cpu")


def test_cli_raises_without_cuda_unless_cpu_asked(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--batch", "1", "--prompt-len", "4", "--max-new", "2"])


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_profile_serve_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import profile_serve
    trace = tmp_path / "decode.json"
    rows = profile_serve.main(["--device", "cpu", "--batch", "1", "--prompt-len",
                               "16", "--decode-steps", "2", "--trace", str(trace)])
    assert [r["phase"] for r in rows] == ["prefill", "decode"]
    assert all(r["wall_ms"] > 0 and r["device_busy_share"] == "not measured"
               for r in rows)
    assert trace.exists()
    assert capsys.readouterr().out.count('"phase"') == 2


def test_profile_serve_runs_mamba_on_cpu(capsys):
    from repro_torch.launch import profile_serve
    rows = profile_serve.main(["--arch", MAMBA_ARCH, "--device", "cpu", "--batch", "1",
                               "--prompt-len", "16", "--decode-steps", "2"])
    assert [r["phase"] for r in rows] == ["prefill", "decode"]
    assert all(r["arch"] == MAMBA_ARCH for r in rows)
