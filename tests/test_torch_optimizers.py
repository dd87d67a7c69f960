"""The port's optimizer registry (``train/state.py::make_optimizer``) against
the JAX package's optax registry, on the CPU.

Each optimizer the config can name (AdamW, Adam, SGD with and without
momentum and Nesterov, RMSprop with and without momentum), built from the
same config by both packages, runs 3 updates from the same parameters and
gradients, with the reference lr schedule, with and without a trainable
mask (optax's ``multi_transform`` with ``set_to_zero``). Updated parameters
at rtol 1e-6 with an absolute floor of 1e-7 (fp32 arithmetic in another
order); frozen parameters bit-equal to their start. The optimizer's count
and its buffers follow optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import compose as jax_compose
from vit_ssl_tpu.train.schedules import lr_schedule_from_config as jax_lr_schedule
from vit_ssl_tpu.train.state import make_optimizer as jax_make_optimizer
from vit_ssl_tpu_torch.config import compose
from vit_ssl_tpu_torch.train.schedules import lr_schedule_from_config
from vit_ssl_tpu_torch.train.state import OptimizerState, make_optimizer

SHAPES = {"a": (4, 3), "b": (3,), "c": (2, 2, 5)}
MASK = {"a": True, "b": False, "c": True}
RTOL, ATOL = 1e-6, 1e-7
STEPS = 3

CASES = {
    "AdamW": ["training.optimizer.params.weight_decay=0.05"],
    "Adam": ["training.optimizer.name=Adam"],
    "SGD": ["training.optimizer.name=SGD"],
    "SGD_momentum": ["training.optimizer.name=SGD", "+training.optimizer.params.momentum=0.9"],
    "SGD_nesterov": ["training.optimizer.name=SGD", "+training.optimizer.params.momentum=0.9",
                     "+training.optimizer.params.nesterov=true"],
    "RMSprop": ["training.optimizer.name=RMSprop", "+training.optimizer.params.alpha=0.9",
                "+training.optimizer.params.eps=1e-3"],
    "RMSprop_momentum": ["training.optimizer.name=RMSprop",
                         "+training.optimizer.params.momentum=0.5",
                         "+training.optimizer.params.eps=1e-3"],
}
# a schedule that moves at every one of the 3 steps (2 steps an epoch,
# warmup over 1 epoch, then the cosine)
SCHEDULE = ["training.warmup_initial_learning_rate=1e-3",
            "training.warmup_final_learning_rate=1e-2", "training.warmup_epochs=1",
            "training.num_epochs=3", "training.lr_scheduler.main.params.eta_min=1e-4"]


def _data():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _configs(overrides):
    args = ("configs", "supervised", SCHEDULE + overrides)
    return jax_compose(*args), compose(*args)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case, masked):
    jax_config, config = _configs(CASES[case])
    params, grads = _data()
    keys = sorted(params)

    tx = jax_make_optimizer(jax_config, jax_lr_schedule(jax_config, 2),
                            dict(MASK) if masked else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)

    optimizer = make_optimizer(config, lr_schedule_from_config(config, 2),
                               [MASK[k] for k in keys] if masked else None)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    state = optimizer.init(tp)
    assert isinstance(state, OptimizerState)
    trained = optimizer.select(tp)
    assert len(trained) == (2 if masked else 3)
    for g in grads:
        optimizer.update(trained, optimizer.select(torch.from_numpy(g[k]) for k in keys),
                         state)
    assert state.count == STEPS
    for k, p in zip(keys, tp):
        want = np.asarray(jp[k])
        if masked and not MASK[k]:
            np.testing.assert_array_equal(p.numpy(), params[k])
            np.testing.assert_array_equal(want, params[k])
        else:
            np.testing.assert_allclose(p.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=k)
            assert not np.array_equal(p.numpy(), params[k])
    for buffers in state.buffers.values():
        assert len(buffers) == len(trained)


def test_rmsprop_puts_eps_inside_the_square_root():
    """One RMSprop step from ν = 0 moves a parameter by lr·g·rsqrt((1 − α)g² +
    eps) (optax), not lr·g/(√((1 − α)g²) + eps) (torch.optim)."""
    _, config = _configs(CASES["RMSprop"])
    optimizer = make_optimizer(config, lambda step: 0.1)
    p = torch.zeros(1)
    g = torch.full((1,), 0.02)
    optimizer.update([p], [g], optimizer.init([p]))
    want = -0.1 * 0.02 / np.sqrt(0.1 * 0.02 ** 2 + 1e-3)
    assert float(p) == pytest.approx(want, rel=1e-6)
    assert abs(float(p) - (-0.1 * 0.02 / (np.sqrt(0.1 * 0.02 ** 2) + 1e-3))) > 1e-4


def test_state_round_trip_and_unknown_names():
    _, config = _configs(CASES["RMSprop_momentum"])
    optimizer = make_optimizer(config, lambda step: 0.1)
    params = [torch.ones(3), torch.ones(2)]
    state = optimizer.init(params)
    optimizer.update(params, [torch.ones(3), torch.ones(2)], state)
    saved = state.state_dict()
    assert set(saved) == {"count", "nu", "trace"}
    fresh = optimizer.init(params)
    fresh.load_state_dict({k: [t.clone() for t in v] if isinstance(v, list) else v
                           for k, v in saved.items()})
    assert fresh.count == 1 and all(torch.equal(a, b) for a, b in
                                    zip(fresh.buffers["nu"], state.buffers["nu"]))
    with pytest.raises(ValueError, match="buffers"):
        make_optimizer(_configs([])[1], lambda step: 0.1).init(params).load_state_dict(saved)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer(_configs(["training.optimizer.name=Lion"])[1], lambda step: 0.1)
