"""The port's trainers resume from the JAX package's checkpoints under
``parallel.fsdp``, ``parallel.pp`` and ``parallel.tp`` (two gloo processes
on the CPU) to the state that one process resumes to, bit for bit.

The checkpoint's optimizer buffers are keyed by parameter name; each rank
puts them in its optimizer's order over the whole model (under pp, every
stage's trained parameters: ``PipelineState.trained_names``) before its
sharded state takes its part. A finetune inside ``freeze_backbone`` holds
buffers for the head only, so its mask is checked against the checkpoint
under pp and tp too.
"""

import pytest
import torch

from torch_dist_worker import orbax_resume, spawn

CASES = [
    ("dino_step1", "parallel.fsdp=true"),
    ("dino_step1", "parallel.pp=2"),
    ("finetune_frozen", "parallel.pp=2"),
    ("finetune_unfrozen", "parallel.tp=2"),
]


def _trees_equal(a, b, where="state"):
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, where
        assert a.shape == b.shape and torch.equal(a, b), where
    elif isinstance(b, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b))[:4])
        for k in b:
            _trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("fixture,option", CASES,
                         ids=[f"{f}-{o.split('.')[1]}" for f, o in CASES])
def test_parallel_resume_equals_one_process(tmp_path, monkeypatch, fixture, option):
    from vit_ssl_tpu_torch.models import dino as port_dino

    spawn("orbax_resume", 2, tmp_path / "two", fixture, option, timeout=180)
    got = torch.load(tmp_path / "two" / "orbax_resume.pt", weights_only=True)
    monkeypatch.setattr(port_dino, "DINOHead", port_dino.DINOHead)  # restored after
    want = orbax_resume(fixture, [], tmp_path / "one")
    assert want["step"] >= 0
    _trees_equal(got, want)
