"""Import hygiene of the port: `repro_torch` and `chip_smoke.py` import
neither JAX nor the JAX package `repro`, so later slices cannot reach back
into the reference."""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PKG = os.path.join(SRC, "repro_torch")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, SRC) for p in out)


def _module_name(rel):
    name = rel[:-3].replace(os.sep, ".")
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


PORT_FILES = _port_files()
MODULES = [_module_name(f) for f in PORT_FILES]

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.util, json, sys, traceback
    sys.path.insert(0, {src!r})

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    result = {{}}
    for mod in {modules!r}:
        try:
            importlib.import_module(mod)
            result[mod] = "ok"
        except Exception:
            result[mod] = traceback.format_exc()
    try:
        spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        result["chip_smoke"] = "ok"
    except Exception:
        result["chip_smoke"] = traceback.format_exc()
    print(json.dumps(result))
""")


@pytest.fixture(scope="module")
def blocked_imports():
    script = _BLOCKED_IMPORT.format(src=SRC, modules=MODULES,
                                    smoke=os.path.join(REPO, "chip_smoke.py"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES + ["chip_smoke"])
def test_imports_with_jax_and_repro_blocked(blocked_imports, module):
    assert blocked_imports[module] == "ok", blocked_imports[module]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)|from\s+(jax|jaxlib|repro)\b(?!_torch))",
    re.M)


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_source_names_no_jax_or_repro_import(rel):
    path = os.path.join(REPO if rel == "chip_smoke.py" else SRC, rel)
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, (rel, hits)


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.models import lm", "import repro", "  from repro import x"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.models import lm",
               "import torch", "# mirrors repro/models/lm.py"):
        assert not _FORBIDDEN.search(ok), ok
