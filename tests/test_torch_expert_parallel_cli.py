"""Expert parallelism through the port's entry point: a supervised MoE ViT
(2 experts, capacity factor 4; the JAX package's ``tests/test_moe.py``
CLI widths) under ``python -m torch.distributed.run --standalone
--nproc_per_node N -m vit_ssl_tpu_torch.train --device cpu ...`` (gloo),
its ``last_model`` held to the same config in one process (ep = 1):

- ep = 2 over two processes (atol 5e-5, JAX's ``test_ep2_cli_matches_ep1``);
- tp = 2 × ep = 2 over four processes, the experts split over ``expert``
  and each expert's hidden over ``model`` (5e-4, JAX's
  ``test_tp_ep_composed_cli_matches_ep1``).
"""

import os
import subprocess
import sys

import pytest
import torch

from make_synthetic_data import make
from test_torch_parallel_cli import REPO, SUPERVISED, _close, _state

from vit_ssl_tpu_torch.train.__main__ import main as port_main

MOE = [a for a in SUPERVISED if not a.startswith("model.mlp_dim=")] + [
    "model.mlp_dim=64", "model.moe_experts=2", "model.moe_capacity_factor=4.0"]
RUNS = [("ep2", 2, ["parallel.ep=2"]), ("tp2_ep2", 4, ["parallel.tp=2", "parallel.ep=2"])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both distributed runs launched at once, and ep = 1 in this process
    while they train."""
    root = tmp_path_factory.mktemp("epcli")
    data_root = make(str(root / "synth"), n=32, size=24, num_classes=3)
    args = MOE + [f"data.data_dir={data_root}/train_images",
                  f"data.data_csv={data_root}/train_labels.json"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", "-m", "vit_ssl_tpu_torch.train", *args, *extra,
         f"hydra.run.dir={root / name}"], cwd=str(REPO), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for name, n, extra in RUNS}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port_main(args + [f"hydra.run.dir={root / 'ep1'}"])
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
    return root, outs


@pytest.mark.parametrize("name,axes,atol", [
    ("ep2", "{'expert': 2}", 5e-5), ("tp2_ep2", "{'model': 2, 'expert': 2}", 5e-4)])
def test_ep_run_matches_ep1(runs, name, axes, atol):
    """The whole saved state (the model in the reference layout, the
    optimizer's buffers) equals ep = 1's; each rank held its experts."""
    root, outs = runs
    assert f"tensor/expert parallel over {axes}" in outs[name]
    _close(_state(root / name), _state(root / "ep1"), atol)
