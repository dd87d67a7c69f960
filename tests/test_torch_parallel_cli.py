"""The parallel axes through the port's entry point:
``python -m torch.distributed.run --standalone --nproc_per_node N -m
vit_ssl_tpu_torch.train --device cpu ...`` (gloo), at the JAX package's tiny
widths (``tests/test_parallel_cli.py``; the MLP at 1024 so that fsdp has
leaves of 2^15 elements to shard), dropout 0, each run against the same
config in one process:

- supervised: dp = 2, sp = 2 (N = 10: the ring), fsdp at dp = 2, and dp = 2
  × sp = 2 over four processes, at atol 5e-5 (the sp runs 5e-4), as JAX's
  ``test_axis_matches_dp_only``;
- DINO with the device multi-crop at dp = 2 (the center, the statistics and
  the augmentation's partitioned draws), plain and fsdp, against dp = 1;
  the fsdp run's ``last_model`` (full tensors) resumed at world size 1 for
  an epoch ends where dp = 1's resumed run ends.

Every run starts at once (``--standalone``: the launcher picks a free
port), each child under a time limit.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from make_synthetic_data import make

from vit_ssl_tpu_torch.train.__main__ import main as port_main
from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent

SUPERVISED = ["--config-name", "supervised", "--device", "cpu", "model.num_classes=3",
              "data.img_size=24", "data.num_workers=0", "model.embed_dim=32",
              "model.num_heads=4", "model.num_blocks=2", "model.mlp_dim=1024",
              "model.patch_size=8", "model.dropout=0.0",
              "model.compute_dtype=float32", "model.use_flash_attention=false",
              "model.use_fused_mlp=false", "training.num_epochs=1",
              "training.batch_size=8", "training.warmup_epochs=1",
              "training.plain_logging=true", "eval.interval=0"]
DINO = ["--config-name", "dino", "--device", "cpu", "data.img_size=16",
        "data.local_img_size=8", "data.device_augment=true", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.patch_size=8", "model.output_dim=2048", "model.dropout=0.0",
        "model.compute_dtype=float32", "training.batch_size=8",
        "training.num_epochs=1", "training.warmup_epochs=1",
        "training.plain_logging=true", "eval.interval=0", "data.num_workers=0",
        "data.val_split=0.25"]

# (name, processes, base, extra overrides)
RUNS = [
    ("dp2", 2, "sup", []),
    ("sp2", 2, "sup", ["parallel.sp=2"]),
    ("fsdp_dp2", 2, "sup", ["parallel.fsdp=true"]),
    ("dp2_sp2", 4, "sup", ["parallel.sp=2"]),
    ("dino_dp2", 2, "dino", []),
    ("dino_fsdp_dp2", 2, "dino", ["parallel.fsdp=true"]),
]


def _args(base, data_root):
    if base == "sup":
        return SUPERVISED + [f"data.data_dir={data_root}/train_images",
                             f"data.data_csv={data_root}/train_labels.json"]
    return DINO + [f"data.data_dir={data_root}/unlabeled_images"]


def _state(run_dir):
    tree, _ = load_checkpoint(os.path.join(run_dir, "last_model"))
    return tree


def _close(got, want, atol, where="state"):
    if isinstance(want, torch.Tensor):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=atol, rtol=1e-4, err_msg=where)
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], atol, f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, atol, f"{where}[{i}]")
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every distributed run launched at once, and the one-process runs in
    this process while they train."""
    root = tmp_path_factory.mktemp("pcli")
    data_root = make(str(root / "synth"), n=32, size=24, num_classes=3)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = {}
    for name, n, base, extra in RUNS:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", "-m", "vit_ssl_tpu_torch.train",
               *_args(base, data_root), *extra, f"hydra.run.dir={root / name}"]
        procs[name] = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port_main(_args("sup", data_root) + [f"hydra.run.dir={root / 'sup'}"])
        port_main(_args("dino", data_root) + [f"hydra.run.dir={root / 'dino'}"])
    finally:
        torch.set_num_threads(threads)
        outs = {}
        for name, p in procs.items():
            try:
                outs[name] = p.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                outs[name] = p.communicate()[0] + "\n(killed at the time limit)"
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{outs[name][-6000:]}"
    return root, data_root, outs


@pytest.mark.parametrize("name,atol", [("dp2", 5e-5), ("sp2", 5e-4),
                                       ("fsdp_dp2", 5e-5), ("dp2_sp2", 5e-4)])
def test_supervised_axis_matches_one_process(runs, name, atol):
    root, _, outs = runs
    assert "Process group: rank 0 of" in outs[name]
    dp = 1 if name == "sp2" else 2
    assert ("Data sharding: data rank 0/2" in outs[name]) == (dp == 2)
    if name == "fsdp_dp2":
        assert "fsdp over 2 data ranks: {'sharded_full_bytes': 0" not in outs[name]
    _close(_state(root / name)["model"], _state(root / "sup")["model"], atol)


def test_sp_runs_rang(runs):
    """N = 10 tokens: sp = 2 divides them, so no fallback was logged."""
    _, _, outs = runs
    for name in ("sp2", "dp2_sp2"):
        assert "does not divide" not in outs[name]
        assert "'seq': 2" in outs[name]


@pytest.mark.parametrize("name", ["dino_dp2", "dino_fsdp_dp2"])
def test_dino_dp2_matches_one_process(runs, name):
    """dp = 2 with the device multi-crop equals dp = 1 at dropout 0: the
    student, the teacher, the global center and the optimizer's buffers,
    saved whole (under fsdp gathered from the chunks)."""
    root, _, outs = runs
    got, want = _state(root / name), _state(root / "dino")
    _close(got, want, 5e-5)
    if "fsdp" in name:
        assert "fsdp over 2 data ranks" in outs[name]


def test_fsdp_state_resumes_at_world_size_one(runs, tmp_path):
    """The fsdp run's last_model, resumed by one process for an epoch, ends
    where the one-process run's resumed epoch ends."""
    root, data_root, _ = runs
    ends = {}
    for name in ("dino_fsdp_dp2", "dino"):
        resumed = tmp_path / name
        shutil.copytree(root / name / "last_model", resumed / "last_model")
        port_main(_args("dino", data_root) + [
            f"training.resume_from_checkpoint={resumed / 'last_model'}"])
        ends[name] = _state(resumed)
    _close(ends["dino_fsdp_dp2"], ends["dino"], 5e-5)
