"""The port's DINO training step against the JAX package's, on the CPU.

``make_dino_steps`` of both packages runs from the same weights (carried by
the port's bridge) on the same host views, at dropout 0 and with the
teacher's dropout off, so no random stream enters. JAX's attention goes
through its B1 kernel in interpret mode (the gate forced open, as
``tests/test_flash_attention.py`` does), forward and custom-VJP backward;
the port's through the plain versions that its CPU wrapper runs. Also here:
AdamW against ``optax.adamw``, the lr schedule, and the train state's
random streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_ssl_tpu.ops.attention as jax_attention_mod
from vit_ssl_tpu.models.dino import DINONetwork
from vit_ssl_tpu.train import schedules as jax_schedules
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_dino_steps as jax_make_dino_steps
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch
from vit_ssl_tpu_torch.models import DINONetwork as TorchDINONetwork
from vit_ssl_tpu_torch.train import (
    AdamW,
    TrainState,
    lr_schedule_from_config,
    make_dino_steps,
    reference_lr_schedule,
)
from vit_ssl_tpu_torch.utils.checkpoint import dino_state_dict_from_flax

B = 4
WEIGHT = np.array([1, 1, 1, 0], np.float32)  # a padded row, as the loader pads
LR = dict(start_lr=1e-4, target_lr=1e-3, eta_min=1e-5, warmup_epochs=1,
          num_epochs=4, steps_per_epoch=2)
WEIGHT_DECAY = 1e-3
TEACHER_TEMPS = (0.04, 0.05, 0.06)
TEACHER_MOMENTA = (0.996, 0.997, 0.998)


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _batches():
    rng = np.random.default_rng(20)
    return [[rng.random((B, 16, 16, 3), np.float32) for _ in range(2)]
            + [rng.random((B, 8, 8, 3), np.float32) for _ in range(4)]
            for _ in range(3)]


def _jax_net(use_fused_mlp=False):
    return DINONetwork(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32,
                       patch_size=8, num_heads=2, mlp_dim=64, dropout=0.0,
                       output_dim=16, use_fused_mlp=use_fused_mlp)


def _weights():
    net = _jax_net()
    student = _jiggle(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
                      ["params"], 1)
    teacher = _jiggle(student, 2)
    center = np.random.default_rng(3).standard_normal((1, 16)).astype(np.float32)
    return student, teacher, center


def _jax_steps(pack, fused=False):
    """JAX's state after steps 1 and 3, as reference-layout numpy dicts,
    and its losses."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_attention_mod, "attention_nhd_profitable",
                  lambda *a, **kw: True)
    try:
        student, teacher, center = _weights()
        tx = optax.adamw(jax_schedules.reference_lr_schedule(**LR),
                         weight_decay=WEIGHT_DECAY)
        state = create_train_state(student, tx, jax.random.PRNGKey(1),
                                   teacher_params=teacher,
                                   center=jnp.asarray(center))
        step, _ = jax_make_dino_steps(
            _jax_net(fused), tx, num_global_views=2, num_all_views=6,
            student_temp=0.1, center_momentum=0.9, donate=False,
            teacher_dropout=False, pack_locals=pack)
        after, losses = {}, []
        for i, views in enumerate(_batches()):
            batch = {"views": [jnp.asarray(v) for v in views],
                     "weight": jnp.asarray(WEIGHT)}
            state, out = step(state, batch, jnp.float32(TEACHER_TEMPS[i]),
                              jnp.float32(TEACHER_MOMENTA[i]))
            losses.append(float(out["loss"]))
            after[i + 1] = {k: np.asarray(v, np.float32) for k, v in
                            dino_params_to_torch(state.params, state.teacher_params,
                                                 state.center).items()}
    finally:
        patch.undo()
    return pack, after, losses


@pytest.fixture(scope="module", params=[False, True], ids=["unpacked", "packed"])
def jax_run(request):
    return _jax_steps(request.param)


@pytest.fixture(scope="module")
def jax_run_fused():
    """With ``use_fused_mlp`` (packed locals): JAX's FFNs run its B4 kernel
    in interpret mode, forward and custom-VJP backward."""
    return _jax_steps(True, fused=True)


def _port_run(pack, steps, fused=False):
    student, teacher, center = _weights()
    net = TorchDINONetwork(2, (3, 16, 16), 32, 8, 2, 64, dropout=0.0, output_dim=16,
                           use_fused_mlp=fused)
    optimizer = AdamW(reference_lr_schedule(**LR), weight_decay=WEIGHT_DECAY)
    state = TrainState(net, optimizer, seed=0)
    state.load_model_state_dict(dino_state_dict_from_flax(student, teacher, center))
    step, _ = make_dino_steps(optimizer, 2, 6, student_temp=0.1, center_momentum=0.9,
                              teacher_dropout=False, pack_locals=pack)
    losses = []
    for i, views in enumerate(_batches()[:steps]):
        batch = {"views": [torch.from_numpy(v) for v in views],
                 "weight": torch.from_numpy(WEIGHT)}
        out = step(state, batch, TEACHER_TEMPS[i], TEACHER_MOMENTA[i])
        losses.append(float(out["loss"]))
        assert set(out["dino_stats"]) >= {"CenterNorm", "CosineSim"}
    assert state.step == steps
    return state, losses


def _assert_run_matches(jax_run, steps, fused=False):
    pack, after, jax_losses = jax_run
    state, losses = _port_run(pack, steps, fused)
    np.testing.assert_allclose(losses, jax_losses[:steps], rtol=1e-5)
    want = after[steps]
    got = {k: v.detach().numpy() for k, v in state.model_state_dict().items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["center"], want["center"].reshape(1, -1),
                               atol=1e-6, rtol=0)
    schedule = reference_lr_schedule(**LR)
    bound = 2 * sum(schedule(i) for i in range(steps)) + 1e-5
    for key in sorted(set(want) - {"center"}):
        diff = np.abs(got[key] - want[key].reshape(got[key].shape))
        assert diff.max() <= bound, (key, diff.max(), bound)
        close = diff <= 1e-5 + 1e-4 * np.abs(want[key].reshape(diff.shape))
        assert close.mean() >= 0.995, (key, close.mean())


@pytest.mark.parametrize("steps", [1, 3])
def test_dino_step_matches_jax(jax_run, steps):
    """Loss at rtol 1e-5, center at atol 1e-6. Parameters: Adam divides each
    gradient entry by its own RMS, so its first updates are about
    lr·sign(g); where the two frameworks' fp32 sums put a near-zero entry
    on opposite sides of zero, that entry may differ by up to 2·lr a step.
    So every entry is held within 2·Σlr + 1e-5, and 99.5 % of them within
    1e-5 + 1e-4·|p|; the teacher, an EMA of those parameters, likewise."""
    _assert_run_matches(jax_run, steps)


@pytest.mark.parametrize("steps", [1, 3])
def test_dino_step_fused_mlp_matches_jax(jax_run_fused, steps):
    """``use_fused_mlp`` on both sides, at the bars of
    :func:`test_dino_step_matches_jax`: the port's fused FFN (its plain
    versions on the CPU) against JAX's B4 kernel, forward and backward."""
    _assert_run_matches(jax_run_fused, steps, fused=True)


def test_adamw_matches_optax():
    rng = np.random.default_rng(21)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(4)]
    schedule = jax_schedules.reference_lr_schedule(**LR)
    tx = optax.adamw(schedule, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    port = AdamW(reference_lr_schedule(**LR), b1=0.8, b2=0.99, eps=1e-6,
                 weight_decay=0.05)
    port_state = port.init(tp)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        lr = port.update(tp, [torch.from_numpy(x) for x in g], port_state)
        assert lr == pytest.approx(float(schedule(i)), rel=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)
    assert port_state.count == 4


@pytest.mark.parametrize("granularity", ["epoch", "step"])
def test_reference_lr_schedule_matches_jax(granularity):
    kw = dict(start_lr=1e-6, target_lr=1e-4, eta_min=1e-6, warmup_epochs=3,
              num_epochs=9, steps_per_epoch=5, granularity=granularity)
    port, jax_fn = reference_lr_schedule(**kw), jax_schedules.reference_lr_schedule(**kw)
    for step in range(0, 60, 3):
        np.testing.assert_allclose(port(step), float(jax_fn(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_lr_schedule_from_config_matches_jax():
    from vit_ssl_tpu.config import compose, to_container

    cfg = to_container(compose("configs", "dino"))
    port = lr_schedule_from_config(cfg, steps_per_epoch=7)
    jax_fn = jax_schedules.lr_schedule_from_config(cfg, steps_per_epoch=7)
    for step in (0, 5, 69, 70, 71, 300, 699, 10_000):
        np.testing.assert_allclose(port(step), float(jax_fn(step)), rtol=1e-6)


def test_next_generators_are_per_step_and_stream():
    net = TorchDINONetwork(1, (3, 16, 16), 32, 8, 2, 64, output_dim=16)
    state = TrainState(net, AdamW(lambda step: 1e-3), seed=7)

    def draws():
        return [float(torch.rand(1, generator=g)) for g in state.next_generators(3)]

    first = draws()
    assert first == draws()  # the same step redraws the same streams
    assert len(set(first)) == 3
    state.step += 1
    assert not set(draws()) & set(first)


def test_grad_accum_not_ported():
    """Ported since: ``grad_accum=2`` (two microbatches of the padded batch,
    the two-pass path) gives the full batch's loss, gradients, center and
    statistics to rtol 1e-5 (a floor of 1e-6 of each tensor's largest
    entry); a batch it does not divide raises ``ValueError``."""
    outs = {}
    for accum in (1, 2, 3):
        student, teacher, center = _weights()
        net = TorchDINONetwork(2, (3, 16, 16), 32, 8, 2, 64, dropout=0.0, output_dim=16)
        optimizer = AdamW(reference_lr_schedule(**LR), weight_decay=WEIGHT_DECAY)
        state = TrainState(net, optimizer, seed=0)
        state.load_model_state_dict(dino_state_dict_from_flax(student, teacher, center))
        step, _ = make_dino_steps(optimizer, 2, 6, 0.1, 0.9, teacher_dropout=False,
                                  grad_accum=accum, pack_locals=True)
        batch = {"views": [torch.from_numpy(v) for v in _batches()[0]],
                 "weight": torch.from_numpy(WEIGHT)}
        if accum == 3:
            with pytest.raises(ValueError, match="must divide"):
                step(state, batch, TEACHER_TEMPS[0], TEACHER_MOMENTA[0])
            continue
        outs[accum] = step(state, batch, TEACHER_TEMPS[0], TEACHER_MOMENTA[0],
                           with_grads=True), state.center

    def close(got, want):
        atol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)

    (got, got_center), (want, want_center) = outs[2], outs[1]
    close(got["loss"], want["loss"])
    close(got_center, want_center)
    for name, g in got["grads"].items():
        close(g, want["grads"][name])
    for key, value in got["dino_stats"].items():
        close(value, want["dino_stats"][key])


def test_teacher_takes_no_gradient_and_step_trains_with_dropout():
    """Dropout on (student and teacher), views from the device pipeline:
    params, teacher and center all move, the teacher keeps no gradient."""
    _step_and_eval_with_dropout(use_fused_mlp=False)


def test_fused_mlp_step_and_eval_step_with_dropout():
    """The same with ``use_fused_mlp``: the student's fused FFNs take their
    keep-masks and the autograd backward, the teacher's run under
    ``no_grad`` with dropout on, and ``eval_step`` runs them without masks."""
    _step_and_eval_with_dropout(use_fused_mlp=True)


def _step_and_eval_with_dropout(use_fused_mlp):
    from vit_ssl_tpu_torch.data.device_augment import make_multicrop_fn

    net = TorchDINONetwork(1, (3, 16, 16), 32, 8, 2, 64, dropout=0.1, output_dim=16,
                           use_fused_mlp=use_fused_mlp)
    net.reset_parameters(torch.Generator().manual_seed(0))
    optimizer = AdamW(lambda step: 1e-3, weight_decay=1e-3)
    state = TrainState(net, optimizer, seed=1)
    crop = [{"name": "RandomResizedCrop", "params": {"size": 16, "scale": [0.5, 1.0]}},
            {"name": "RandomHorizontalFlip", "params": {}}]
    local = [{"name": "RandomResizedCrop", "params": {"size": 8, "scale": [0.1, 0.4]}}]
    step, eval_step = make_dino_steps(
        optimizer, 2, 6, 0.1, 0.9, view_fn=make_multicrop_fn(crop, local, 2, 6),
        pack_locals=True)
    images = torch.from_numpy(
        np.random.default_rng(22).integers(0, 256, (B, 24, 24, 3), dtype=np.uint8))
    before = {k: v.clone() for k, v in state.model_state_dict().items()}
    out = step(state, {"image": images, "weight": torch.ones(B)}, 0.04, 0.996)
    assert torch.isfinite(out["loss"])
    after = state.model_state_dict()
    for prefix in ("student_", "teacher_", "center"):
        assert any(not torch.equal(before[k], after[k]) for k in after
                   if k.startswith(prefix)), prefix
    assert all(p.grad is None for p in state.teacher.parameters())
    center = state.center.clone()
    ev = eval_step(state, {"image": images, "weight": torch.ones(B)}, 0.04)
    assert torch.isfinite(ev["loss"]) and not torch.equal(center, state.center)
