"""One rank of a gloo process group on the CPU, for the port's parallel
tests (``tests/test_torch_ring_attention.py``, ``tests/test_torch_parallel.py``).

    python tests/torch_dist_worker.py CASE RANK WORLD STORE_DIR OUT_DIR [ARGS...]

The group meets through a ``FileStore`` under ``STORE_DIR`` (no port, so
parallel test workers cannot collide). Each case writes
``OUT_DIR/<case>_<rank>.npz``. Imports torch and the port only.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

torch.set_num_threads(1)


def qkv(b=2, h=3, n=32, d=16, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                 .to(dtype) for _ in range(3))


def case_ring(rank, world, out, n="32"):
    """The port's ring over the world (one seq group): the fp32 output and
    the q/k/v gradients of sum(out²), the bf16 output, and rank 0's
    virtual-rank body over the same inputs."""
    from vit_ssl_tpu_torch.parallel.ring_attention import (
        ring_attention, virtual_ring_backward, virtual_ring_forward)

    group = dist.group.WORLD
    q, k, v = qkv(n=int(n))
    scale = 1.0 / np.sqrt(q.shape[-1])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = ring_attention(q, k, v, scale, group)
    (o ** 2).sum().backward()
    qb, kb, vb = qkv(n=int(n), dtype=torch.bfloat16)
    with torch.no_grad():
        ob = ring_attention(qb, kb, vb, scale, group)
    res = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
           "dv": v.grad.numpy(), "o_bf16": ob.float().numpy()}
    if rank == 0:
        q0, k0, v0 = qkv(n=int(n))
        vo, vlse = virtual_ring_forward(q0, k0, v0, scale, world)
        dq, dk, dv = virtual_ring_backward(q0, k0, v0, vo, vlse, 2 * vo.float(), scale,
                                           world)
        res.update({"virtual_o": vo.numpy(), "virtual_dq": dq.numpy(),
                    "virtual_dk": dk.numpy(), "virtual_dv": dv.numpy()})
    np.savez(out / f"ring_{rank}.npz", **res)


def _tiny_supervised(extra=()):
    from vit_ssl_tpu_torch.config import compose

    return compose(str(REPO / "configs"), "supervised", [
        "model.num_classes=3", "data.img_size=16", "model.embed_dim=32",
        "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
        "model.patch_size=4", "model.dropout=0.0", "model.compute_dtype=float32",
        "training.batch_size=8",
        "training.optimizer.name=SGD", "+training.optimizer.params.momentum=0.9",
        *extra])


def global_batch(seed=3):
    """A last-partial global batch of 8 rows: 4 real (weight 1), 4 pads."""
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8),
            "label": rng.integers(0, 3, 8).astype(np.int64),
            "weight": np.asarray([1, 1, 1, 1, 0, 0, 0, 0], np.float32)}


def step_once(config, batch, group=None, fsdp=False):
    """One supervised SGD step (lr 1) of a seeded tiny ViT on ``batch``;
    returns the parameters after it, the summed gradients it took, the
    step's loss (this rank's share) and, under fsdp, the bytes each rank
    keeps (``ShardedState.bytes_at_rest``, the parameters' storage, the
    optimizer buffers)."""
    from vit_ssl_tpu_torch.models.builder import build_model
    from vit_ssl_tpu_torch.parallel.data_parallel import DataParallelOptimizer
    from vit_ssl_tpu_torch.parallel.fsdp import ShardedState
    from vit_ssl_tpu_torch.train.state import SupervisedTrainState, make_optimizer
    from vit_ssl_tpu_torch.train.steps import make_supervised_steps

    model = build_model(config, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    inner = make_optimizer(config, lambda step: 1.0)
    taken = {}
    update = inner.update

    def recording(params, grads, state):
        taken["grads"] = [g.clone() for g in grads]
        return update(params, grads, state)

    inner.update = recording
    optimizer = inner if group is None else DataParallelOptimizer(inner, group)
    state = SupervisedTrainState(model, optimizer, 0)
    sharded = None
    if fsdp:
        sharded = ShardedState([model], state.opt_state, optimizer.select(state.params),
                               group, min_size=64)
        optimizer.sharded = sharded
    train_step, _ = make_supervised_steps(optimizer)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    if sharded is not None:
        train_step = sharded.around(train_step)
    out = train_step(state, tensors)
    rest = {}
    if sharded is not None:
        rest = sharded.bytes_at_rest()
        rest["storage_bytes_at_rest"] = sum(p.untyped_storage().nbytes()
                                            for p in model.parameters())
        rest["moment_bytes"] = sum(b.numel() * b.element_size()
                                   for bufs in state.opt_state.buffers.values()
                                   for b in bufs)
        with sharded.materialized():
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
    else:
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return params, taken["grads"], float(out["loss"]), rest


def case_grads(rank, world, out, fsdp="0"):
    """One data-parallel step over this rank's interleaved rows of
    :func:`global_batch` (dp = world): the parameters after it and its loss
    share, against which the test puts the single-process step."""
    from vit_ssl_tpu_torch.parallel import context
    from vit_ssl_tpu_torch.parallel.mesh import mesh_from_config

    config = _tiny_supervised()
    mesh = mesh_from_config(config)
    context.set_parallel_context(mesh)
    batch = {k: v[rank::world] for k, v in global_batch().items()}
    params, _, loss, rest = step_once(config, batch, mesh.groups["data"], fsdp == "1")
    np.savez(out / f"grads{fsdp}_{rank}.npz", loss=loss, **rest,
             **{f"param:{n}": p.numpy() for n, p in params.items()})


def case_patch_scores(rank, world, out):
    """One data-parallel supervised step (dp = world) with patch dropout 0.5
    over this rank's rows of :func:`global_batch`: the patch scores the
    model drew, the state of the generator they came from, the state of
    this rank's dropout stream of the step, and the parameters after it."""
    from vit_ssl_tpu_torch.models import vit as vit_mod
    from vit_ssl_tpu_torch.parallel import context
    from vit_ssl_tpu_torch.parallel.mesh import mesh_from_config
    from vit_ssl_tpu_torch.train.state import step_generators

    config = _tiny_supervised(["model.patch_dropout=0.5"])
    mesh = mesh_from_config(config)
    context.set_parallel_context(mesh)
    drawn = []
    real = vit_mod.draw_patch_scores

    def recording(generator, batch, num_patches):
        before = generator.get_state().clone()
        scores = real(generator, batch, num_patches)
        drawn.append((before, scores))
        return scores

    vit_mod.draw_patch_scores = recording
    batch = {k: v[rank::world] for k, v in global_batch().items()}
    params, _, _, _ = step_once(config, batch, mesh.groups["data"])
    (before, scores), = drawn
    stream = step_generators(0, 0, 2, "cpu", per_rank=(0,))[0]
    np.savez(out / f"patch_scores_{rank}.npz", scores=scores.numpy(),
             generator_state=before.numpy(), stream_state=stream.get_state().numpy(),
             **{f"param:{n}": p.numpy() for n, p in params.items()})


def case_loaders(rank, world, out):
    """The loaders of a dp = world / 2 × sp = 2 mesh: each rank's train
    batches of one epoch (the seq ranks of a data index load the same
    rows)."""
    from vit_ssl_tpu_torch.config import compose
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.data.datasets import Dataset

    class Numbered(Dataset):
        def __len__(self):
            return 20

        def __getitem__(self, idx, rng=None):
            return np.full((2, 2, 3), idx, np.uint8)

    config = compose(str(REPO / "configs"), "dino", [
        "parallel.sp=2", "training.batch_size=8", "data.num_workers=0",
        "data.val_split=0.0"])
    train, _ = make_loaders(config, Numbered())
    train.set_epoch(1)
    batches = list(train)
    np.savez(out / f"loaders_{rank}.npz",
             ids=np.stack([b["image"][:, 0, 0, 0] for b in batches]),
             weight=np.stack([b["weight"] for b in batches]))


def case_dtensor(rank, world, out):
    """Each kernel's wrapper given a sharded ``DTensor``: the ``TypeError``
    messages (one a kernel, "" where none was raised)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from vit_ssl_tpu_torch.ops import flash_attention as fa
    from vit_ssl_tpu_torch.ops import flash_blockwise as fb
    from vit_ssl_tpu_torch.ops import fused_mlp as fm
    from vit_ssl_tpu_torch.ops import masked_matmul as mm

    mesh = init_device_mesh("cpu", (world,))

    def dt(*shape):
        return distribute_tensor(torch.randn(*shape), mesh, [Shard(0)])

    x = torch.randn(2, 8, 64)
    heads = torch.randn(2, 2, 8, 32)
    calls = {
        "attention_nhd": lambda: fa.attention_nhd(dt(2, 8, 64), x, x, 2, 0.1),
        "fused_attention": lambda: fa.fused_attention(heads, dt(2, 2, 8, 32), heads, 0.1),
        "blockwise_attention": lambda: fb.blockwise_attention(heads, heads,
                                                              dt(2, 2, 8, 32), 0.1),
        "fused_mlp": lambda: fm.fused_mlp(torch.randn(4, 384), dt(1536, 384),
                                          torch.randn(1536), torch.randn(384, 1536),
                                          torch.randn(384)),
        "masked_matmul": lambda: mm.masked_matmul(
            torch.randn(4, 1536), torch.ones(4, 1536, dtype=torch.bool),
            dt(384, 1536), torch.randn(384), 0.9),
    }
    messages = {}
    for name, call in calls.items():
        try:
            call()
            messages[name] = ""
        except TypeError as e:
            messages[name] = str(e)
    np.savez(out / f"dtensor_{rank}.npz", **messages)


# the DINO trainer tests' tiny config (tests/test_torch_dino_trainer.py::TINY)
DINO_TINY = ["data.img_size=16", "data.local_img_size=8", "data.device_augment=false",
             "model.embed_dim=32", "model.num_heads=2", "model.num_blocks=2",
             "model.mlp_dim=64", "model.patch_size=8", "model.output_dim=16",
             "model.dropout=0.0", "model.compute_dtype=float32",
             "training.batch_size=4", "training.num_epochs=2",
             "training.warmup_epochs=1", "training.plain_logging=true",
             "eval.interval=0"]


class HostViews:
    """``n`` batches of host views (2 globals of ``g`` px, 4 locals of ``l``
    px) and weights, drawn with numpy from (seed, epoch): the DINO trainer
    tests' loader."""

    def __init__(self, n, seed, weights, g=16, l=8, b=4):
        self.n, self.seed, self.weights, self.epoch = n, seed, weights, 0
        self.g, self.l, self.b = g, l, b

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for i in range(self.n):
            views = ([rng.random((self.b, self.g, self.g, 3), np.float32)
                      for _ in range(2)]
                     + [rng.random((self.b, self.l, self.l, 3), np.float32)
                        for _ in range(4)])
            yield {"views": views, "weight": np.asarray(self.weights[i], np.float32)}


def dino_fit(overrides, save_path):
    """A DINO trainer over :class:`HostViews` (2 train batches, 1 val batch)
    after ``fit(1)``: its state in host memory, full tensors."""
    from vit_ssl_tpu_torch.config import compose
    from vit_ssl_tpu_torch.models import build_dino_network
    from vit_ssl_tpu_torch.train.trainers import DINOTrainer

    config = compose(str(REPO / "configs"), "dino", list(overrides))
    g, l = int(config.data.img_size), int(config.data.local_img_size)
    train = HostViews(2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]], g, l)
    val = HostViews(1, 8, [[1, 1, 0, 0]], g, l)
    trainer = DINOTrainer(build_dino_network(config, "cpu"), str(save_path), config,
                          train, val, "cpu")
    trainer.fit(1)
    return trainer._host_state()


def case_dino_fit(rank, world, out, *overrides):
    """:func:`dino_fit` on every rank; rank 0 saves the state."""
    tree = dino_fit(overrides, out / "run")
    if rank == 0:
        torch.save(tree, out / "dino_fit.pt")


def case_preempt(rank, world, out, *overrides):
    """:func:`dino_fit`'s trainer through the CLI's preemption flow with
    ``training.fault_inject_preempt_step=1``: every rank's exit code."""
    from vit_ssl_tpu_torch.config import compose
    from vit_ssl_tpu_torch.models import build_dino_network
    from vit_ssl_tpu_torch.train.__main__ import fit_with_preemption
    from vit_ssl_tpu_torch.train.trainers import DINOTrainer

    config = compose(str(REPO / "configs"), "dino", list(overrides) + [
        "training.fault_inject_preempt_step=1"])
    g, l = int(config.data.img_size), int(config.data.local_img_size)
    trainer = DINOTrainer(build_dino_network(config, "cpu"), str(out / "run"), config,
                          HostViews(2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]], g, l),
                          HostViews(1, 8, [[1, 1, 0, 0]], g, l), "cpu")
    code = None
    try:
        fit_with_preemption(trainer, config, str(out / "run"))
    except SystemExit as e:
        code = e.code
    np.savez(out / f"preempt_{rank}.npz", code=-1 if code is None else code)


def spawn(case, world, tmp, *args, timeout=240):
    """Run ``case`` on ``world`` gloo ranks under ``tmp`` (each child with a
    time limit, so a hang fails); returns ``tmp``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), case, str(r), str(world),
         str(tmp), str(tmp), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{text[-4000:]}"
    return tmp


def main(argv):
    case, rank, world, store_dir, out = argv[:5]
    rank, world = int(rank), int(world)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        globals()[f"case_{case}"](rank, world, Path(out), *argv[5:])
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
