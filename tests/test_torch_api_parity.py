"""The port's public surface against the JAX package's, on the CPU.

For every public function, method and ``__init__`` of every module of
``fspann_tpu`` (leading-underscore names excluded; jitted functions
included), the JAX parameters are a prefix of the port counterpart's: the
same names, kinds and defaults, in the same order (``inspect.signature``).
Parameters only the port has (a ``device``, a chunk size) come after them
and have defaults, so a call written for the JAX package binds the same
arguments in the port or fails loudly — it never shifts a positional
argument into another parameter.

``MODULES`` and ``NAMES`` map the JAX modules and functions whose port
counterpart has another name.  ``RESULT_NEUTRAL`` holds the parameters
whose difference cannot change a result, each with its reason; none may
name ``approx``.  A JAX parameter there that the port lacks must be one of
the last of its function's parameters.

The JAX-style positional calls of ``scan`` and ``scan_chunked`` at the end
(``limit, approx, anchor, margin, floor``) give both packages' ids, scores
and adaptive decrypt budgets, equal.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fspann_tpu
from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import hamming_scan as jhs
from fspann_tpu_torch.ops import hamming_scan as ths

torch.set_num_threads(1)

# JAX module -> port module, where the names differ
MODULES = {"fspann_tpu.ops.pallas_topk": "fspann_tpu_torch.ops.l2_topk"}
# JAX qualified name -> the port's name in the mapped module
NAMES = {"ops.pallas_topk.bitonic_topk": "l2_topk"}

# "qualified name:parameter" -> why the difference cannot change a result
RESULT_NEUTRAL = {
    "ops.pallas_topk.bitonic_topk:tile_n":
        "the TPU kernel's base tile; the CUDA kernel picks its own launch "
        "geometry (ops/l2_topk._splits) and returns the exact top-k either "
        "way",
    "ops.pallas_topk.bitonic_topk:q_tile":
        "the TPU kernel's query tile, sized for a v5e's scoped VMEM; the "
        "CUDA kernel's query block is fixed at 64",
    "ops.pallas_topk.bitonic_topk:interpret":
        "Pallas interpret mode; a CUDA kernel has none, and the port runs "
        "its plain twin for a tensor on the CPU",
    "ops.hamming_scan.build_scan_state:chunk":
        "rows unpacked per step while building; the bit matrix is the same "
        "for every chunk, the port's smaller default bounds the device "
        "scratch",
    "io.groundtruth.precompute:backend":
        "None picks the L2 top-k kernel on a CUDA device and its plain twin "
        "on the CPU; both are the exact L2 top-k, and the JAX names 'xla' "
        "and 'pallas' select the same two paths",
}


def _public_callables(module):
    """(qualified name, function) of ``module``'s own public functions,
    jitted functions and class methods (``__init__`` included)."""
    for name, obj in vars(module).items():
        if name.startswith("_") \
                or getattr(obj, "__module__", None) != module.__name__:
            continue
        if inspect.isclass(obj):
            for mname, member in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                if isinstance(member, (staticmethod, classmethod)):
                    member = member.__func__
                if inspect.isfunction(member):
                    yield f"{name}.{mname}", member
        elif inspect.isfunction(obj) or (callable(obj)
                                         and hasattr(obj, "__wrapped__")):
            yield name, obj


def _cases():
    out = []
    for info in pkgutil.walk_packages(fspann_tpu.__path__, "fspann_tpu."):
        jmod = importlib.import_module(info.name)
        tname = MODULES.get(info.name,
                            "fspann_tpu_torch" + info.name[len("fspann_tpu"):])
        for inner, fn in _public_callables(jmod):
            qual = f"{info.name[len('fspann_tpu.'):]}.{inner}"
            out.append((qual, fn, tname, NAMES.get(qual, inner)))
    return out


CASES = _cases()


def _port_callable(tname: str, name: str):
    """The port's ``name`` (a function, or ``Class.method``) in module
    ``tname``."""
    obj = importlib.import_module(tname)
    for part in name.split("."):
        obj = inspect.getattr_static(obj, part, None)
        if obj is None:
            return None
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return obj


def _same_default(a, b) -> bool:
    if a is b:
        return True
    try:
        return type(a) is type(b) and bool(a == b)
    except (TypeError, ValueError):
        return False


@pytest.mark.parametrize("qual,jfn,tname,name", CASES,
                         ids=[c[0] for c in CASES])
def test_signature_is_the_jax_packages(qual, jfn, tname, name):
    tfn = _port_callable(tname, name)
    assert tfn is not None, f"{tname} has no counterpart of {qual}"
    jparams = list(inspect.signature(jfn).parameters.values())
    tparams = list(inspect.signature(tfn).parameters.values())
    tnames = {p.name for p in tparams}
    absent = [p.name for p in jparams if p.name not in tnames]
    for pname in absent:
        assert f"{qual}:{pname}" in RESULT_NEUTRAL, \
            f"the port's {qual} lacks {pname}"
    kept = jparams[:len(jparams) - len(absent)]
    assert [p.name for p in jparams[len(kept):]] == absent, \
        f"{qual}: the JAX parameters the port lacks are not the last ones"
    assert len(tparams) >= len(kept)
    for j, t in zip(kept, tparams):
        assert (t.name, t.kind) == (j.name, j.kind), \
            f"{qual}: port has {t} where JAX has {j}"
        if f"{qual}:{j.name}" not in RESULT_NEUTRAL:
            assert _same_default(j.default, t.default), \
                f"{qual}: default of {j.name}: JAX {j.default!r}, port " \
                f"{t.default!r}"
    for t in tparams[len(kept):]:
        assert t.default is not inspect.Parameter.empty or t.kind in (
            inspect.Parameter.VAR_POSITIONAL,
            inspect.Parameter.VAR_KEYWORD), \
            f"{qual}: the port's own parameter {t.name} has no default"


def test_result_neutral_allowlist_is_live():
    """Each entry names a JAX parameter that the port leaves out or
    defaults otherwise, and no entry names ``approx``."""
    cases = {c[0]: c[1:] for c in CASES}
    for key in RESULT_NEUTRAL:
        qual, param = key.split(":")
        assert "approx" not in key
        jfn, tname, name = cases[qual]
        j = inspect.signature(jfn).parameters[param]
        t = inspect.signature(_port_callable(tname, name)).parameters.get(
            param)
        assert t is None or not _same_default(j.default, t.default), key


# -- the JAX-style positional calls -----------------------------------------


def _codes(rng, n, nq, d=24):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = rng.normal(size=(nq, d)).astype(np.float32) * 4
    bank = jcoding.build_bank_from_sample(base[:256], 10, 2, 2, 2, 3)
    codes, _ = jcoding.encode_numpy(base, bank)
    qcodes, _ = jcoding.encode_numpy(queries, bank)
    return codes, jhs.unpack_bits_numpy(qcodes, bank.code_bits), \
        bank.code_bits


def _assert_route_equal(j, t):
    for f in ("ids", "scores", "n_dec"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


@pytest.mark.parametrize("entry", ["scan", "scan_chunked", "scan_chunked "
                                   "packed"])
def test_jax_style_positional_scan_call(rng, entry):
    """``(state, qbits, tombstones, limit, [chunk,] approx, anchor, margin,
    floor[, code_bits])`` written positionally binds the same parameters in
    both packages: equal ids, scores and adaptive decrypt budgets."""
    codes, qbits, cb = _codes(rng, 900, 4)
    tomb = rng.random(900) < 0.05
    jargs = (jnp.asarray(qbits), jnp.asarray(tomb))
    targs = (torch.from_numpy(qbits), torch.from_numpy(tomb))
    if entry == "scan":
        tail = (200, True, 10, 6)
        j = jhs.scan(jhs.build_scan_state(codes, cb), *jargs, *tail)
        t = ths.scan(ths.build_scan_state(codes, cb), *targs, *tail)
    elif entry == "scan_chunked":
        tail = (60, 256, True, 10, 8, 12)
        j = jhs.scan_chunked(jhs.build_scan_state(codes, cb), *jargs, *tail)
        t = ths.scan_chunked(ths.build_scan_state(codes, cb), *targs, *tail)
    else:
        tail = (60, 256, True, 10, 8, 12, cb)
        j = jhs.scan_chunked(jhs.build_scan_state_packed(codes, cb), *jargs,
                             *tail)
        t = ths.scan_chunked(ths.build_scan_state_packed(codes, cb), *targs,
                             *tail)
    assert t.n_dec is not None
    _assert_route_equal(j, t)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_groundtruth_takes_the_jax_backend_names(rng, backend):
    """``precompute``'s JAX names pick the port's two paths ("xla" the
    chunked product + top-k, "pallas" the L2 top-k kernel, its plain twin on
    the CPU): the JAX package's exact ground truth either way."""
    from fspann_tpu.io import groundtruth as jgt
    from fspann_tpu_torch.io import groundtruth as tgt

    base = rng.normal(size=(3000, 16)).astype(np.float32)
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    want = jgt.precompute(base, queries, k=10, chunk=1000)
    got = tgt.precompute(base, queries, k=10, chunk=1000, backend=backend,
                         device="cpu")
    np.testing.assert_array_equal(got.gt, want.gt)
    with pytest.raises(ValueError, match="unknown GT backend"):
        tgt.precompute(base, queries, k=10, backend="tpu", device="cpu")
