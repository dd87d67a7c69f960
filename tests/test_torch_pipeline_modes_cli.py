"""Pipeline parallelism through the port's entry point in every training
mode (gloo, ``--device cpu``, the JAX package's widths, dropout 0), each
run's ``last_model`` held to the same config in one process:

- DINO at pp = 2 with the device multi-crop and the packed locals (both
  the globals and the locals, with their block-diagonal mask, go through
  the stages; the teacher's globals too) (atol 5e-5); its automatic
  evaluation (rank 0 alone, on an unpipelined copy of the teacher gathered
  from the stages) writes the one-process run's summary;
- SimMIM at pp = 2 (5e-5);
- finetune at pp = 2 from a DINO ``.pth`` (extended transfer, the backbone
  frozen for epoch 1 and unfrozen for epoch 2: the optimizer rebuilt on
  each stage's parameters) (5e-5);
- tp = 2 × pp = 2 × sp = 2 over eight processes (5e-4, JAX's
  ``test_combined_tp_pp_sp``);
- the DINO pp = 2 run's ``last_model`` resumed by one process for an epoch
  ends where the one-process run's resumed epoch ends.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from make_synthetic_data import make
from test_torch_parallel_cli import REPO, _close, _state
from test_torch_tensor_parallel_cli import _args, _dino_pth

from vit_ssl_tpu_torch.train.__main__ import main as port_main

# (name, processes, base, extra overrides)
RUNS = [
    ("dino_pp2", 2, "dino_eval", ["parallel.pp=2"]),
    ("simmim_pp2", 2, "simmim", ["parallel.pp=2"]),
    ("finetune_pp2", 2, "finetune", ["parallel.pp=2"]),
    ("sup_tp2_pp2_sp2", 8, "sup", ["parallel.tp=2", "parallel.pp=2", "parallel.sp=2"]),
]
ONE_PROCESS = [("dino", "dino_eval", []), ("simmim", "simmim", []),
               ("finetune", "finetune", []), ("sup", "sup", [])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every distributed run launched at once, and the one-process runs in
    this process while they train."""
    root = tmp_path_factory.mktemp("ppmodes")
    data_root = make(str(root / "synth"), n=32, size=24, num_classes=3)
    _dino_pth(f"{data_root}/dino.pth")
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
        assert p.returncode == 0, f"{name} failed:\n{outs[name][-6000:]}"
    return root, data_root, outs


@pytest.mark.parametrize("name,want,atol", [
    ("dino_pp2", "dino", 5e-5), ("simmim_pp2", "simmim", 5e-5),
    ("finetune_pp2", "finetune", 5e-5), ("sup_tp2_pp2_sp2", "sup", 5e-4)])
def test_pp_mode_matches_one_process(runs, name, want, atol):
    """The whole saved state (model or student and teacher, DINO's center,
    the optimizer's buffers) of the pp run equals one process's."""
    root, _, outs = runs
    assert "Pipeline parallelism: 2 stages x 1 blocks/stage" in outs[name]
    if name == "finetune_pp2":
        assert "Unfreezing backbone and rebuilding optimizer" in outs[name]
    if name == "sup_tp2_pp2_sp2":
        assert "'model': 2, 'pipe': 2, 'seq': 2" in outs[name]
        assert "ring attention cannot run inside pipeline stages" in outs[name]
    _close(_state(root / name), _state(root / want), atol)


def test_pp_evaluation_matches_one_process(runs):
    """The pp run's evaluation (KNN, the linear probe, UMAP's quality) reads
    the same teacher as one process's: the same summary."""
    root, _, _ = runs
    summaries = [(root / name / "epoch_1" / "evaluation_summary.csv").read_text()
                 for name in ("dino_pp2", "dino")]
    assert summaries[0] == summaries[1]
    assert "eval_knn" in summaries[0]


def test_pp_dino_state_resumes_at_world_size_one(runs, tmp_path):
    """The DINO pp = 2 run's last_model, resumed by one process for an epoch,
    ends where the one-process run's resumed epoch ends."""
    root, data_root, _ = runs
    ends = {}
    for name in ("dino_pp2", "dino"):
        resumed = tmp_path / name
        shutil.copytree(root / name / "last_model", resumed / "last_model")
        port_main(_args("dino", data_root) + [
            f"training.resume_from_checkpoint={resumed / 'last_model'}"])
        ends[name] = _state(resumed)
    _close(ends["dino_pp2"], ends["dino"], 5e-5)
