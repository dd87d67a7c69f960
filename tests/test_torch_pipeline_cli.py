"""Pipeline parallelism through the port's entry point, supervised:
``python -m torch.distributed.run --standalone --nproc_per_node N -m
vit_ssl_tpu_torch.train --device cpu ... parallel.pp=2`` (gloo), at the JAX
package's widths (``tests/test_parallel_cli.py``), dropout 0, each run's
``last_model`` (whole tensors, the reference layout) held to the same
config in one process:

- pp = 2 (atol 5e-5, JAX's ``pp2``); pp = 2 × ``pp_interleave`` = 2 at 4
  blocks (5e-4, JAX's ``test_pp_interleave_matches_dp_only``), 4
  microbatches;
- dp = 2 × pp = 2 and tp = 2 × pp = 2 over four processes (5e-5); pp = 2 ×
  sp = 2 (5e-4: the ring does not run inside the stages, with JAX's
  warning); fsdp at dp = 2 × pp = 2 (5e-5, the MLP at 1024 so that fsdp
  has leaves to shard);
- JAX's ``num_blocks=3`` refusal, with its message;
- the pp = 2 run's ``last_model`` loads ``strict=True`` into an unsharded
  port ViT, and one process resumes it for an epoch, ending where the
  one-process run's resumed epoch ends.

DINO, SimMIM, finetune and tp × pp × sp: ``tests/test_torch_pipeline_modes_cli.py``.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from make_synthetic_data import make
from test_torch_parallel_cli import REPO, SUPERVISED, _close, _state

from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.models.builder import build_model
from vit_ssl_tpu_torch.train.__main__ import main as port_main

# the JAX package's pp test widths (tests/test_parallel_cli.py)
SUP = [a for a in SUPERVISED if not a.startswith("model.mlp_dim=")] + ["model.mlp_dim=64"]
FOUR = ["model.num_blocks=4"]

# (name, processes, base, extra overrides)
RUNS = [
    ("pp2", 2, "sup", ["parallel.pp=2"]),
    ("pp2_v2", 2, "sup", FOUR + ["parallel.pp=2", "parallel.pp_interleave=2",
                                 "parallel.pp_microbatches=4"]),
    ("dp2_pp2", 4, "sup", ["parallel.pp=2"]),
    ("tp2_pp2", 4, "sup", ["parallel.tp=2", "parallel.pp=2"]),
    ("pp2_sp2", 4, "sup", ["parallel.pp=2", "parallel.sp=2"]),
    ("fsdp_dp2_pp2", 4, "sup_wide", ["parallel.pp=2", "parallel.fsdp=true"]),
    ("pp2_blocks3", 2, "sup", ["parallel.pp=2", "model.num_blocks=3"]),
]
ONE_PROCESS = [("sup", "sup", []), ("sup4", "sup", FOUR), ("sup_wide", "sup_wide", [])]


def _args(base, data_root):
    data = [f"data.data_dir={data_root}/train_images",
            f"data.data_csv={data_root}/train_labels.json"]
    return (SUPERVISED if base == "sup_wide" else SUP) + data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every distributed run launched at once, and the one-process runs in
    this process while they train."""
    root = tmp_path_factory.mktemp("ppcli")
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
        for name, base, extra in ONE_PROCESS:
            port_main(_args(base, data_root) + extra + [f"hydra.run.dir={root / name}"])
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
        if name != "pp2_blocks3":
            assert p.returncode == 0, f"{name} failed:\n{outs[name][-6000:]}"
    return root, data_root, outs, {name: p.returncode for name, p in procs.items()}


@pytest.mark.parametrize("name,want,atol", [
    ("pp2", "sup", 5e-5), ("pp2_v2", "sup4", 5e-4), ("dp2_pp2", "sup", 5e-5),
    ("tp2_pp2", "sup", 5e-5), ("pp2_sp2", "sup", 5e-4),
    ("fsdp_dp2_pp2", "sup_wide", 5e-5)])
def test_pp_run_matches_one_process(runs, name, want, atol):
    """The whole saved state (the model, the optimizer's buffers) of the pp
    run equals one process's, and the run logged its layout."""
    root, _, outs, _ = runs
    assert "Pipeline parallelism: 2 stages x" in outs[name]
    _close(_state(root / name), _state(root / want), atol)


def test_pp_layouts_logged(runs):
    """The interleaved run's chunks and bubble fraction (JAX's log line);
    the stages' blocks; pp × sp's warning; the meshes."""
    _, _, outs, _ = runs
    assert ("2 stages x 2 blocks/stage (interleave 2: 2 virtual chunks of 1 blocks per "
            "device), microbatches=4, bubble fraction=0.111") in outs["pp2_v2"]
    assert "pipeline stage 1 of 2 holds encoder blocks [1, 3]" in outs["pp2_v2"]
    assert "microbatches=2, bubble fraction=0.333" in outs["pp2"]
    assert "ring attention cannot run inside pipeline stages" in outs["pp2_sp2"]
    assert "ring attention cannot" not in outs["pp2"]
    assert "'data': 2, 'pipe': 2" in outs["dp2_pp2"]
    assert "'model': 2, 'pipe': 2" in outs["tp2_pp2"]
    assert "fsdp over 2 data ranks" in outs["fsdp_dp2_pp2"]


def test_pp_must_divide_blocks(runs):
    """JAX's ``test_pp_must_divide_blocks``: pp = 2 over 3 blocks is refused
    with JAX's message."""
    _, _, outs, codes = runs
    assert codes["pp2_blocks3"] != 0
    assert ("parallel.pp=2 × parallel.pp_interleave=1 must divide model.num_blocks=3"
            in outs["pp2_blocks3"])


def test_pp_last_model_loads_strictly_unsharded(runs):
    """The pp run's model is whole, in the reference layout: it loads
    ``strict=True`` into an unsharded port ViT built from the same config."""
    root, data_root, _, _ = runs
    config = compose(str(REPO / "configs"), "supervised",
                     [a for a in _args("sup", data_root)
                      if "=" in a and not a.startswith("--")])
    model = build_model(config, "cpu")
    model.load_state_dict(_state(root / "pp2")["model"], strict=True)


def test_pp_state_resumes_at_world_size_one(runs, tmp_path):
    """The pp = 2 run's last_model, resumed by one process for an epoch,
    ends where the one-process run's resumed epoch ends."""
    root, data_root, _, _ = runs
    ends = {}
    for name in ("pp2", "sup"):
        resumed = tmp_path / name
        shutil.copytree(root / name / "last_model", resumed / "last_model")
        port_main(_args("sup", data_root) + [
            f"training.resume_from_checkpoint={resumed / 'last_model'}"])
        ends[name] = _state(resumed)
    assert ends["sup"]["step"] > _state(root / "sup")["step"]
    _close(ends["pp2"], ends["sup"], 5e-5)
