"""The port serves from the CUDA card unless its caller names another device.

Without a CUDA device every entry point raises at construction, with the way
to ask for the CPU, instead of carrying on on the CPU.  ``torch.cuda`` is
reported absent (or present) by monkeypatching ``torch.cuda.is_available``."""

import numpy as np
import pytest
import torch

import fspann_tpu_torch
from fspann_tpu_torch.api import cli
from fspann_tpu_torch.api.multidim import MultiDimSystem
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.config import SystemConfig
from fspann_tpu_torch.io import groundtruth
from fspann_tpu_torch.parallel.serving import DistributedEncryptedSystem
from fspann_tpu_torch.parallel.sharded import make_mesh

NO_CUDA = "no CUDA device is available; pass device=\"cpu\""


def write_fvecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, 1 + d), "<f4")
    out[:, 0] = np.full(n, d, "<i4").view("<f4")
    out[:, 1:] = arr
    out.tofile(path)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        fspann_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match=NO_CUDA):
        fspann_tpu_torch.resolve_device("cuda:0")
    assert fspann_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert fspann_tpu_torch.default_device() == torch.device("cuda")
    assert fspann_tpu_torch.resolve_device(None) == torch.device("cuda")


@pytest.mark.parametrize("entry", ["system", "multidim", "distributed",
                                   "mesh", "groundtruth"])
def test_entry_points_need_the_cpu_asked_for(no_cuda, tmp_path, entry):
    cfg = SystemConfig().validate()
    base = np.zeros((8, 4), np.float32)
    build = {
        "system": lambda **kw: ForwardSecureANNSystem(
            cfg, str(tmp_path / "s"), 4, **kw).index,
        "multidim": lambda **kw: MultiDimSystem(
            cfg, str(tmp_path / "m"), **kw).system_for(4).index,
        "distributed": lambda **kw: DistributedEncryptedSystem(
            cfg, str(tmp_path / "d"), 4, **kw).mesh,
        "mesh": lambda **kw: make_mesh(2, **kw),
        "groundtruth": lambda **kw: groundtruth.precompute(
            base, base[:2], k=1, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match=NO_CUDA):
        build()
    got = build(device="cpu")
    if entry != "groundtruth":
        assert got.device == torch.device("cpu")


def test_cli_runs_on_the_cpu_only_by_request(no_cuda, tmp_path, capsys):
    rng = np.random.default_rng(0)
    write_fvecs(str(tmp_path / "b.fvecs"),
                rng.normal(size=(300, 8)).astype(np.float32))
    write_fvecs(str(tmp_path / "q.fvecs"),
                rng.normal(size=(4, 8)).astype(np.float32))
    args = ["--data", str(tmp_path / "b.fvecs"),
            "--queries", str(tmp_path / "q.fvecs"), "--gt", "AUTO",
            "--results", str(tmp_path / "res"), "--no-reencrypt"]
    with pytest.raises(RuntimeError, match=NO_CUDA):
        cli.main(args + ["--base-dir", str(tmp_path / "a")])
    assert cli.main(args + ["--base-dir", str(tmp_path / "b"),
                            "--device", "cpu"]) == 0
