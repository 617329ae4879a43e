"""The port imports torch and never jax, and its carried host modules do not
drift from the JAX package's sources.

``import fspann_tpu.<anything>`` runs ``fspann_tpu/__init__.py``, which
imports jax, so the port carries its own copies of the jax-free host
modules instead of importing them.  Each copy's code must equal its
source's, compared as syntax trees without import statements and
docstrings (the one sanctioned code edit: ``crypto/aesgcm.py`` and
``ops/native_scan.py`` build their C library into the port's build
directory instead of running ``make`` inside ``fspann_tpu``).  The two C
sources those libraries are built from are carried too, byte for byte, and
no Python file of the port, of its examples or of ``chip_smoke.py`` names a
path under ``fspann_tpu/`` in its code.  The carried entry points
(``api/system.py``, ``api/multidim.py``, ``api/cli.py``) differ from their
sources by a ``device`` parameter alone: the port serves from the CUDA card
unless its caller names another device, and nothing in the port asks
``torch.cuda.is_available()`` to pick the CPU.  The port's tracing is its
own too: with its spans unwrapped, its counters dropped and the recorder's
definitions and the ``SearchStats`` fields they fill taken out (``TRACE``),
every carried module equals its source.  A carried module may hold members
that are the port's own (``PORT_OWN``): a public one repairs the member of
the same name in place and is held to the JAX package by a behaviour test
instead, a private one is the port's helper for them, and a public field
the source lacks is an option of the port's own, with a default, after the
source's fields; they are taken out of both trees, and every other member
is still held equal."""

import ast
import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "fspann_tpu")
PORT = os.path.join(REPO, "fspann_tpu_torch")
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py")))

CARRIED = ["config.py", "types.py", "crypto/aesgcm.py", "crypto/keys.py",
           "crypto/rotation.py", "crypto/coordinator.py", "store/arena.py",
           "store/metadata.py", "store/point_store.py",
           "store/write_buffer.py", "io/loaders.py", "io/synthetic.py",
           "query/aggregates.py", "query/diagnostics.py", "query/token.py",
           "utils/cache.py", "utils/metrics.py", "utils/profiler.py",
           "utils/storage_metrics.py", "api/system.py", "api/cli.py",
           "api/multidim.py", "query/decoy.py", "crypto/keyutils.py",
           "utils/paths.py", "interfaces.py", "ops/native_scan.py",
           "store/sharded_store.py"]

# Modules that bind a C library: the library path constants and the build
# step of ``_load`` differ; everything from ``lib = ctypes.CDLL(...)`` on
# must not, and the port's ``_load`` takes its path from ``_build``
NATIVE_BUILD = {"_NATIVE_DIR", "_LIB_PATH", "_load"}
NATIVE_LIBS = {"crypto/aesgcm.py": "aes_gcm_library_path()",
               "ops/native_scan.py": "native_scan_library_path()"}
# C sources: the JAX package's file -> the port's copy under csrc/native/
CARRIED_C = {"crypto/native/aes_gcm.c": "csrc/native/aes_gcm.c",
             "ops/native/hamming_topl.c": "csrc/native/hamming_topl.c"}
# Carried entry points that take the device to serve from (``device=`` /
# ``--device``); with it taken out they must equal their sources
DEVICE_PARAM = {"api/system.py", "api/multidim.py", "api/cli.py"}


class _WithoutDevice(ast.NodeTransformer):
    """Takes the ``device`` parameter out of a module: the argument and its
    default, ``device=`` keywords, ``self.device = ...`` and the
    ``--device`` option."""

    def visit_arguments(self, node):
        names = [a.arg for a in node.args]
        if "device" in names:
            i = names.index("device")
            j = i - (len(node.args) - len(node.defaults))
            node.args.pop(i)
            if j >= 0:
                node.defaults.pop(j)
        return self.generic_visit(node)

    def visit_Call(self, node):
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return self.generic_visit(node)

    def visit_Assign(self, node):
        t = node.targets[0]
        if isinstance(t, ast.Attribute) and t.attr == "device":
            return None
        return self.generic_visit(node)

    def visit_Expr(self, node):
        v = node.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                and v.func.attr == "add_argument" and v.args \
                and isinstance(v.args[0], ast.Constant) \
                and v.args[0].value == "--device":
            return None
        return self.generic_visit(node)


# The port's tracing in carried modules, by module: the span recorder's
# top-level definitions and the ``SearchStats`` fields the query service
# fills from the spans, by qualified name
TRACE = {
    "utils/profiler.py": {
        "SPAN_HISTORY", "_SPAN_LOCK", "_SPAN_LOCAL", "_SPAN_STATS",
        "_SPAN_COUNTERS", "_SPAN_ROOTS", "_SPAN_SEQ", "_span_stack", "span",
        "count", "recent", "totals", "reset", "_GC_OPEN", "_gc_span"},
    "types.py": {f"SearchStats.{f}" for f in (
        "dispatch_ns", "wait_ns", "token_open_ns", "lookup_ns", "open_ns",
        "upload_ns", "track_ns", "stage_a_device_ns")},
}


def _traced(node, name):
    """``node`` is a call of the recorder's ``name`` (bare or as
    ``profiler.<name>``) whose first argument is a string constant and
    whose other arguments call nothing but ``len``."""
    if not isinstance(node, ast.Call) or not node.args \
            or not isinstance(node.args[0], ast.Constant) \
            or not isinstance(node.args[0].value, str):
        return False
    f = node.func
    if not ((isinstance(f, ast.Name) and f.id == name) or (
            isinstance(f, ast.Attribute) and f.attr == name
            and isinstance(f.value, ast.Name) and f.value.id == "profiler")):
        return False
    return all(isinstance(c.func, ast.Name) and c.func.id == "len"
               for arg in node.args[1:] + [k.value for k in node.keywords]
               for c in ast.walk(arg) if isinstance(c, ast.Call))


# Members of carried modules that are the port's own, by module and
# qualified name: taken out of the JAX package's tree and the port's alike.
# A public one keeps its source's name and signature and is held to the JAX
# package's member by a behaviour test; a private one is a helper the
# source does not have; a dataclass field is an option the source lacks,
# whose default keeps the source's behaviour.  The read:
# ``tests/test_torch_parallel_read.py``
PORT_OWN = {
    "config.py": {"RuntimeConfig.setup_threads"},
    "store/point_store.py": {"PointStore.load_decrypt_batch",
                             "PointStore.load_score_batch",
                             "PointStore._open_records"},
}


class _WithoutNames(ast.NodeTransformer):
    """Takes the definitions ``trace`` names (``name`` at the module's top
    level, ``Class.name`` in its classes) out of a module, and the module's
    statements that use one (the ``gc.callbacks`` hook)."""

    def __init__(self, trace=frozenset()):
        self.trace = trace

    def _keep(self, stmts, scope=""):
        out = []
        for st in stmts:
            if {scope + n for n in _names(st)} & self.trace:
                continue
            if not scope and isinstance(st, ast.Expr) and any(
                    isinstance(n, ast.Name) and n.id in self.trace
                    for n in ast.walk(st)):
                continue
            out.append(st)
        return out

    def visit_Module(self, node):
        self.generic_visit(node)
        node.body = self._keep(node.body)
        return node

    def visit_ClassDef(self, node):
        self.generic_visit(node)
        node.body = self._keep(node.body, node.name + ".") or [ast.Pass()]
        return node


class _WithoutSpans(_WithoutNames):
    """Takes the port's tracing out of a module: each ``with span("...")``
    block becomes its body, ``count("...", n)`` statements go, and so do
    the definitions ``trace`` names."""

    def visit_With(self, node):
        self.generic_visit(node)
        items = [i for i in node.items if i.optional_vars is not None
                 or not _traced(i.context_expr, "span")
                 or len(i.context_expr.args) != 1]
        if items:
            node.items = items
            return node
        return node.body

    def visit_Expr(self, node):
        if _traced(node.value, "count"):
            return None
        return self.generic_visit(node)


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
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return {stmt.target.id}
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


def _check_carried(rel, port):
    """Asserts that the port's tree of the carried module ``rel`` equals its
    source, the port's tracing and its sanctioned differences set aside."""
    own = PORT_OWN.get(rel, frozenset())
    src = _WithoutNames(own).visit(_tree(os.path.join(JAX_PKG, rel)))
    port = _WithoutSpans(TRACE.get(rel, frozenset()) | own).visit(port)
    if rel in NATIVE_LIBS:
        assert _code(port, NATIVE_BUILD) == _code(src, NATIVE_BUILD)
        assert _bindings(port) == _bindings(src)
        with open(os.path.join(PORT, rel)) as f:
            text = f.read()
        assert NATIVE_LIBS[rel] in text and "subprocess" not in text
    elif rel in DEVICE_PARAM:
        assert _code(port) != _code(src)          # the parameter is there
        assert _code(_WithoutDevice().visit(port)) == _code(src)
    else:
        assert _code(port) == _code(src)


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_module_matches_source(rel):
    _check_carried(rel, _tree(os.path.join(PORT, rel)))


def _changed(rel, old, new):
    """The port's tree of ``rel`` with the one line ``old`` replaced."""
    with open(os.path.join(PORT, rel)) as f:
        text = f.read()
    if text.count(old) != 1:       # not an AssertionError: see the caller
        raise LookupError(old)
    tree = ast.parse(text.replace(old, new))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return tree


_SEALED = "            aads = aad_batch(ids, kv, self.dim)\n"
_COUNTED = _SEALED + "            profiler.count(\"store.sealed\", {})\n"


@pytest.mark.parametrize("rel,old,new", [
    # inside a span block: store.seal's AADs
    ("store/point_store.py", _SEALED,
     "            aads = aad_batch(ids, kv + 1, self.dim)\n"),
    # inside a span block: the token's query digest
    ("query/token.py", "pt, digest_size=16).digest()))",
     "pt, digest_size=8).digest()))"),
    # outside every span block
    ("store/point_store.py", "TAG_LEN = aesgcm.TAG_LEN",
     "TAG_LEN = aesgcm.TAG_LEN + 1"),
    ("api/system.py", "        self._cache_gen += 1\n        return restored",
     "        return restored"),
    # a counter whose argument changes the state
    ("store/point_store.py", _SEALED,
     _COUNTED.format("len(ids) + ivs.fill(0)")),
    # a member of a module with port-own members, not one of them: the
    # store's arena open, which the port-own read calls
    ("store/point_store.py",
     "        if r is None or r.size != os.path.getsize(path):",
     "        if r is None:"),
], ids=["store-seal", "token-seal", "store-constant", "system-undelete",
        "mutating-count", "store-open"])
def test_carried_check_fails_on_a_changed_copy(rel, old, new):
    """A carried module changed inside a span block, or outside one, or
    through a counter's argument, or in a member that is not the port's
    own, no longer equals its source once its tracing and its port-own
    members are taken out."""
    with pytest.raises(AssertionError):
        _check_carried(rel, _changed(rel, old, new))


def test_carried_check_admits_a_counter():
    """A counter of a string name and a length is the port's tracing."""
    _check_carried("store/point_store.py",
                   _changed("store/point_store.py", _SEALED,
                            _COUNTED.format("len(ids)")))


def _members(tree):
    """Qualified names of a module's top-level and class-level
    definitions."""
    out = set()
    for st in tree.body:
        out |= _names(st)
        if isinstance(st, ast.ClassDef):
            out |= {f"{st.name}.{n}" for s in st.body for n in _names(s)}
    return out


def _fields(tree, cls):
    """(name, has a default) of class ``cls``'s annotated fields, in
    order."""
    node = next(s for s in tree.body
                if isinstance(s, ast.ClassDef) and s.name == cls)
    return [(s.target.id, s.value is not None) for s in node.body
            if isinstance(s, ast.AnnAssign)
            and isinstance(s.target, ast.Name)]


@pytest.mark.parametrize("rel,name", sorted(
    (rel, name) for rel, names in PORT_OWN.items() for name in names))
def test_port_own_names_a_member(rel, name):
    """Every name in ``PORT_OWN`` is a member of the port's module.  A
    public one is a member of the JAX package's module too (a repair in
    place, never a fork beside it), or else a field of the port's own with
    a default, after every field of the source's class (an option the
    source lacks: a call written for the source binds as before); a private
    one is not (a helper of the port's own, never a carried member let
    go)."""
    assert rel in CARRIED
    port = _tree(os.path.join(PORT, rel))
    src = _tree(os.path.join(JAX_PKG, rel))
    assert name in _members(port)
    public = not name.rsplit(".", 1)[-1].startswith("_")
    in_source = name in _members(src)
    if public and not in_source:
        cls, field = name.split(".")
        fields = _fields(port, cls)
        theirs = [f for f, _ in _fields(src, cls)]
        at = [f for f, _ in fields].index(field)
        assert dict(fields)[field], f"{name} has no default"
        assert not set(theirs) & {f for f, _ in fields[at:]}, \
            f"{name} comes before a field of the source"
    else:
        assert in_source == public


@pytest.mark.parametrize("rel", sorted(CARRIED_C))
def test_carried_c_source_equals_source(rel):
    with open(os.path.join(JAX_PKG, rel), "rb") as f:
        src = f.read()
    with open(os.path.join(PORT, CARRIED_C[rel]), "rb") as f:
        assert f.read() == src


def test_build_reads_only_the_ports_sources():
    from fspann_tpu_torch import _build

    for path in (_build.AES_GCM_SRC, _build.NATIVE_SCAN_SRC, _build.CSRC_DIR,
                 _build.BUILD_DIR):
        assert os.path.commonpath([PORT, path]) == PORT, path
    assert _build.AES_GCM_SRC == os.path.join(PORT, CARRIED_C[
        "crypto/native/aes_gcm.c"])
    assert _build.NATIVE_SCAN_SRC == os.path.join(PORT, CARRIED_C[
        "ops/native/hamming_topl.c"])


def _code_strings(path):
    """Every string constant of a module's code, docstrings left out."""
    return [n.value for n in ast.walk(_tree(path))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_no_python_file_builds_a_path_into_the_jax_package():
    """No string in the port's code is the JAX package's directory name or a
    path below it.  ``chip_smoke.py`` may say which JAX line a kernel
    replaces (``file.py:line``, the ``replaces`` key of its record); it may
    not name a file otherwise."""
    part = re.compile(r"(^|[\\/])fspann_tpu($|[\\/])")
    files = [os.path.join(REPO, "chip_smoke.py")] + EXAMPLES
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, fn) for fn in names
                  if fn.endswith(".py")]
    assert len(files) > 45 and len(EXAMPLES) == 5
    for path in files:
        for text in _code_strings(path):
            if path.endswith("chip_smoke.py") \
                    and re.fullmatch(r"fspann_tpu/[\w/]+\.py:\d+", text):
                continue
            assert not part.search(text), f"{path}: {text!r}"


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


def _port_and_example_files():
    files = list(EXAMPLES)
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, fn) for fn in names
                  if fn.endswith(".py")]
    return files


def test_no_jax_import_statement_in_port():
    pat = re.compile(r"^\s*(import jax|from jax|import fspann_tpu\b|"
                     r"from fspann_tpu\b(?!_torch))")
    files = _port_and_example_files()
    assert os.path.join(PORT, "ops", "threefry.py") in files
    for path in files:
        with open(path) as f:
            for i, ln in enumerate(f, 1):
                assert not pat.match(ln), f"{path}:{i}: {ln.strip()}"


def test_threefry_imports_neither_jax_nor_torch():
    """``ops/threefry.py`` stands alone on numpy (loaded by path, so the
    package ``__init__`` and its torch import stay out)."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('threefry', "
            f"{os.path.join(PORT, 'ops', 'threefry.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch', 'fspann_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_only_the_device_rule_asks_for_cuda():
    """No module of the port but ``__init__.py`` (``default_device``) and
    ``utils/devmem.py`` (a read-only memory query) calls
    ``torch.cuda.is_available()``: nothing picks the CPU by itself."""
    allowed = {os.path.join(PORT, "__init__.py"),
               os.path.join(PORT, "utils", "devmem.py")}
    callers = set()
    for path in _port_and_example_files():
        for n in ast.walk(_tree(path)):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "is_available" \
                    and "cuda" in ast.dump(n.func.value):
                callers.add(path)
    assert callers <= allowed, sorted(callers - allowed)
    assert os.path.join(PORT, "__init__.py") in callers
