"""The port imports torch and never jax, and its carried host modules do not
drift from the JAX package's sources.

``import fspann_tpu.<anything>`` runs ``fspann_tpu/__init__.py``, which
imports jax, so the port carries its own copies of the jax-free host
modules instead of importing them.  Each copy's code must equal its
source's, compared as syntax trees without import statements and
docstrings (the one sanctioned code edit: ``crypto/aesgcm.py`` builds the
C library into the port's build directory instead of running ``make``
inside ``fspann_tpu``)."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "fspann_tpu")
PORT = os.path.join(REPO, "fspann_tpu_torch")

CARRIED = ["config.py", "types.py", "crypto/aesgcm.py", "crypto/keys.py",
           "crypto/rotation.py", "crypto/coordinator.py", "store/arena.py",
           "store/metadata.py", "store/point_store.py",
           "store/write_buffer.py", "io/loaders.py", "io/synthetic.py",
           "query/aggregates.py", "query/diagnostics.py", "query/token.py",
           "utils/cache.py", "utils/metrics.py", "utils/profiler.py",
           "utils/storage_metrics.py", "api/system.py"]

# crypto/aesgcm.py: the library path constants and the build step of
# ``_load`` differ; everything from ``lib = ctypes.CDLL(...)`` on must not
AESGCM_BUILD = {"_NATIVE_DIR", "_LIB_PATH", "_load"}


def _tree(path):
    """Module AST with every docstring removed."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return tree


def _names(stmt):
    if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
        return {stmt.name}
    if isinstance(stmt, ast.Assign):
        return {t.id for t in stmt.targets if isinstance(t, ast.Name)}
    return set()


def _code(tree, drop=frozenset()):
    return [ast.dump(s) for s in tree.body
            if not isinstance(s, (ast.Import, ast.ImportFrom))
            and not _names(s) & drop]


def _bindings(tree):
    """``_load``'s statements from ``lib = ctypes.CDLL(...)`` on."""
    fn = next(s for s in tree.body
              if isinstance(s, ast.FunctionDef) and s.name == "_load")
    body = next(s for s in fn.body if isinstance(s, ast.With)).body
    i = next(k for k, s in enumerate(body) if _names(s) == {"lib"})
    return [ast.dump(s) for s in body[i + 1:]]


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_module_matches_source(rel):
    src, port = (_tree(os.path.join(JAX_PKG, rel)),
                 _tree(os.path.join(PORT, rel)))
    if rel == "crypto/aesgcm.py":
        assert _code(port, AESGCM_BUILD) == _code(src, AESGCM_BUILD)
        assert _bindings(port) == _bindings(src)
        with open(os.path.join(PORT, rel)) as f:
            text = f.read()
        assert "aes_gcm_library_path()" in text and "subprocess" not in text
    else:
        assert _code(port) == _code(src)


def _port_modules():
    import fspann_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        fspann_tpu_torch.__path__, "fspann_tpu_torch."))


def test_port_never_imports_jax():
    mods = _port_modules()
    assert "fspann_tpu_torch.api.system" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'fspann_tpu' or m.startswith('fspann_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_statement_in_port():
    pat = re.compile(r"^\s*(import jax|from jax|import fspann_tpu\b|"
                     r"from fspann_tpu\b(?!_torch))")
    for dirpath, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    for i, ln in enumerate(f, 1):
                        assert not pat.match(ln), f"{fn}:{i}: {ln.strip()}"
