"""The port's parallel axes (``vit_ssl_tpu_torch/parallel/``) against the JAX
package's: the mesh from the config (its axes and JAX's refusals), pp
still refused by the trainer (tp and ep pass it), fsdp's sharding rule, the loaders
sharded by the data rank under sp, the partitioned per-image draws, and
one data-parallel step (plain and fsdp) over two gloo processes equal to
the single-process step over the concatenated global batch, including a
last partial batch (JAX ``tests/test_multihost.py``).
"""

import numpy as np
import pytest
import torch

from torch_dist_worker import _tiny_supervised, global_batch, spawn, step_once
from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.parallel import mesh_from_config as jax_mesh_from_config
from vit_ssl_tpu.parallel.fsdp import fsdp_spec_for
from vit_ssl_tpu.parallel.mesh import create_mesh
from vit_ssl_tpu_torch.config import ConfigValidationError, compose, validate_train_config
from vit_ssl_tpu_torch.parallel import context
from vit_ssl_tpu_torch.parallel.fsdp import DEFAULT_MIN_SIZE, fsdp_dim_for
from vit_ssl_tpu_torch.parallel.mesh import Mesh, axis_sizes
from vit_ssl_tpu_torch.train.state import step_generators
from vit_ssl_tpu_torch.train.trainers.base import refuse_unported_training

CONFIGS = "configs"


def _cfg(*overrides):
    return compose(CONFIGS, "supervised", list(overrides))


@pytest.mark.parametrize("overrides", [
    (), ("parallel.tp=2",), ("parallel.sp=2",), ("parallel.pp=2", "parallel.sp=2"),
    ("parallel.sp=4",), ("parallel.sp=2", "parallel.ep=2"),
], ids=lambda o: " ".join(o) or "default")
def test_mesh_axes_match_jax(overrides):
    """Over 8 processes, the port's axes and sizes are JAX's over its 8 CPU
    devices: data implicit and first, size-1 axes left out."""
    jax_mesh = jax_mesh_from_config(jax_compose(CONFIGS, "supervised", list(overrides)))
    sizes = axis_sizes(_cfg(*overrides), 8)
    assert sizes == dict(jax_mesh.shape)
    assert tuple(sizes) == tuple(jax_mesh.axis_names)


@pytest.mark.parametrize("overrides", [("parallel.tp=3",), ("parallel.sp=3",),
                                       ("parallel.pp=2", "parallel.sp=3")])
def test_mesh_rejects_indivisible_as_jax(overrides):
    with pytest.raises(ValueError, match="divide") as jax_error:
        jax_mesh_from_config(jax_compose(CONFIGS, "supervised", list(overrides)))
    with pytest.raises(ValueError, match="divide") as port_error:
        axis_sizes(_cfg(*overrides), 8)
    assert str(port_error.value) == str(jax_error.value)


def test_mesh_rank_coordinates_are_row_major():
    """Rank r of a (data 2, seq 2) mesh: the ranks of one data index are
    consecutive, as JAX reshapes its device list."""
    coords = [Mesh({"data": 2, "seq": 2}, r).coords for r in range(4)]
    assert coords == [{"data": 0, "seq": 0}, {"data": 0, "seq": 1},
                      {"data": 1, "seq": 0}, {"data": 1, "seq": 1}]


def test_num_devices_below_the_world_is_refused():
    with pytest.raises(ValueError, match="num_devices"):
        axis_sizes(_cfg("parallel.num_devices=2"), 4)
    assert axis_sizes(_cfg("parallel.num_devices=4"), 4) == {"data": 4}


@pytest.mark.parametrize("overrides", [
    ("parallel.fsdp=true", "parallel.tp=2"),
    ("parallel.fsdp=true", "parallel.ep=2", "model.moe_experts=2"),
], ids=["fsdp_tp", "fsdp_ep"])
def test_fsdp_conflicts_refused_as_jax(overrides):
    base = ("model.num_classes=3", "data.data_dir=/tmp", "data.data_csv=/tmp/x")
    from vit_ssl_tpu.config import validate_train_config as jax_validate
    from vit_ssl_tpu.config.schemas import ConfigValidationError as JaxError

    with pytest.raises(JaxError, match="fsdp"):
        jax_validate(jax_compose(CONFIGS, "supervised", list(base + overrides)))
    with pytest.raises(ConfigValidationError, match="fsdp"):
        validate_train_config(_cfg(*(base + overrides)))


@pytest.mark.parametrize("overrides", [("parallel.sp=2",), ("parallel.fsdp=true",),
                                       ("+parallel.multihost=true",), ("parallel.tp=2",),
                                       ("parallel.ep=2", "model.moe_experts=2"),
                                       ("parallel.pp=2",)])
def test_sp_fsdp_multihost_pass_the_trainer(overrides):
    refuse_unported_training(_cfg(*overrides))


@pytest.mark.parametrize("shape", [(384, 1536), (1536, 384), (16384, 384), (384,),
                                   (1, 197, 768), (768, 3, 16, 16), (3, 5), (100, 1000)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_rule_matches_jax(shape, n):
    """The dimension each leaf shards along is the one JAX's
    ``fsdp_spec_for`` names (min_size 2^15)."""
    spec = tuple(fsdp_spec_for(shape, create_mesh(n), min_size=DEFAULT_MIN_SIZE))
    want = spec.index("data") if "data" in spec else None
    assert fsdp_dim_for(shape, n) == want


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """One supervised step on two gloo ranks, plain and fsdp, and the same
    step in this process over the whole global batch."""
    root = tmp_path_factory.mktemp("dp")
    out = {f: spawn("grads", 2, root / f"fsdp{f}", f, timeout=180) for f in "01"}
    ranks = {f: [dict(np.load(out[f] / f"grads{f}_{r}.npz")) for r in range(2)]
             for f in "01"}
    ref = step_once(_tiny_supervised(), global_batch())
    return ranks, ref


@pytest.mark.parametrize("fsdp", ["0", "1"], ids=["dp2", "fsdp_dp2"])
def test_step_equals_single_process_global_batch(dp_runs, fsdp):
    """dp = 2 over a last partial batch (4 real rows of 8, interleaved over
    the ranks): the summed loss shares are the global loss, and the
    parameters after the step (SGD at lr 1: minus the gradient) are the
    single-process step's on every rank."""
    ranks, (params, _, loss, _) = dp_runs
    got = ranks[fsdp]
    assert float(got[0]["loss"]) + float(got[1]["loss"]) == pytest.approx(loss, rel=1e-6)
    for name, p in params.items():
        np.testing.assert_allclose(got[0][f"param:{name}"], p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got[0][f"param:{name}"], got[1][f"param:{name}"])


def test_fsdp_keeps_a_half_of_the_large_leaves(dp_runs):
    """fsdp at dp = 2: each rank keeps half of every sharded parameter's
    bytes, and between steps the full parameters hold no memory."""
    ranks, _ = dp_runs
    plain, sharded = ranks["0"][0], ranks["1"]
    for r in sharded:
        assert int(r["sharded_full_bytes"]) > 0
        assert int(r["sharded_local_bytes"]) * 2 == int(r["sharded_full_bytes"])
        assert int(r["storage_bytes_at_rest"]) == int(r["replicated_bytes"])
    assert set(plain) <= set(sharded[0]) | {"loss"}


def test_loaders_shard_by_the_data_rank(tmp_path):
    """dp = 2 × sp = 2 over 4 ranks: the seq ranks of a data index load the
    same rows; the two data indices split each global batch (20 samples at
    batch 8: the last global batch's 4 real rows among them)."""
    out = spawn("loaders", 4, tmp_path, timeout=120)
    runs = [dict(np.load(out / f"loaders_{r}.npz")) for r in range(4)]
    for a, b in ((0, 1), (2, 3)):
        for key in ("ids", "weight"):
            np.testing.assert_array_equal(runs[a][key], runs[b][key])
    real = [set(runs[r]["ids"][runs[r]["weight"] > 0].tolist()) for r in (0, 2)]
    assert real[0].isdisjoint(real[1]) and real[0] | real[1] == set(range(20))
    assert runs[0]["ids"].shape == (3, 4)


@pytest.mark.parametrize("rank", [0, 1])
def test_draws_are_the_rank_rows_of_the_global_draws(rank):
    """Under dp = 2, data rank r's per-image draws (device augmentation,
    SimMIM's mask) are rows r, r + 2, … of what one process draws for the
    global batch, from the same stream."""
    from vit_ssl_tpu_torch.data.device_augment import RandomResizedCrop
    from vit_ssl_tpu_torch.models.simmim import make_random_mask

    whole_crop = RandomResizedCrop(8).draw(torch.Generator().manual_seed(5), 8, 16, 16)
    whole_mask = make_random_mask(torch.Generator().manual_seed(6), 8, 16, 0.5)
    context.set_parallel_context(Mesh({"data": 2}, rank))
    try:
        crop = RandomResizedCrop(8).draw(torch.Generator().manual_seed(5), 4, 16, 16)
        mask = make_random_mask(torch.Generator().manual_seed(6), 4, 16, 0.5)
        gens = step_generators(0, 3, 4, "cpu", per_rank=(0,))
    finally:
        context.set_parallel_context(None)
    for key in whole_crop:
        torch.testing.assert_close(crop[key], whole_crop[key][rank::2], rtol=0, atol=0)
    torch.testing.assert_close(mask, whole_mask[rank::2], rtol=0, atol=0)
    single = step_generators(0, 3, 4, "cpu", per_rank=(0,))
    draws = [torch.rand(4, generator=g) for g in gens]
    plain = [torch.rand(4, generator=g) for g in single]
    assert not torch.equal(draws[0], plain[0])  # the dropout stream folds the rank in
    for a, b in zip(draws[1:], plain[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_patch_scores_come_from_each_rank_dropout_stream(tmp_path):
    """dp = 2, a supervised step with patch dropout 0.5 through the real
    step streams: each rank draws the scores of its own rows only (4 of
    the global 8), first from its own dropout stream (the step's stream 0
    with the data rank folded in), so the ranks draw different scores; the
    parameters after the step are the same on both ranks."""
    out = spawn("patch_scores", 2, tmp_path, timeout=180)
    runs = [dict(np.load(out / f"patch_scores_{r}.npz")) for r in range(2)]
    for run in runs:
        assert run["scores"].shape == (4, 16)
        np.testing.assert_array_equal(run["generator_state"], run["stream_state"])
    assert not np.array_equal(runs[0]["scores"], runs[1]["scores"])
    assert not np.array_equal(runs[0]["stream_state"], runs[1]["stream_state"])
    params = [k for k in runs[0] if k.startswith("param:")]
    assert params
    for key in params:
        np.testing.assert_array_equal(runs[0][key], runs[1][key], err_msg=key)


def test_preemption_exits_75_on_every_rank(tmp_path):
    """A fault injected after one train batch, two gloo ranks with
    parallel.fsdp: both stop at that boundary and exit 75; rank 0 wrote
    preempt_model (full tensors) once."""
    import json

    from torch_dist_worker import DINO_TINY

    out = spawn("preempt", 2, tmp_path, *DINO_TINY, "parallel.fsdp=true", timeout=180)
    codes = [int(np.load(out / f"preempt_{r}.npz")["code"]) for r in range(2)]
    assert codes == [75, 75]
    meta = json.loads((out / "run" / "preempt_model" / "metadata.json").read_text())
    assert (meta["preempt_epoch"], meta["preempt_batches_done"]) == (1, 1)
    tree = torch.load(out / "run" / "preempt_model" / "state.pt", weights_only=True)
    head = tree["student"]["head.fully_connected.parametrizations.weight.original1"]
    assert head.shape == (16, 32) and tree["step"] == 1


def test_multihost_without_the_launcher_raises(monkeypatch):
    """parallel.multihost=true outside torch.distributed.run: the entry
    point asks for the launcher's environment instead of training alone."""
    from vit_ssl_tpu_torch.train.__main__ import init_distributed

    for key in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        init_distributed(_cfg("+parallel.multihost=true"), "cpu")
    assert init_distributed(_cfg(), "cpu") == (torch.device("cpu"), False)

