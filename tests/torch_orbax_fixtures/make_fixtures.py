"""Write the orbax checkpoint fixtures beside this file, and ``digests.json``.

Each fixture is a checkpoint directory (``metadata.json`` and an orbax
``tree/``) that the JAX package's own trainers wrote through their own
``_save`` or ``save_preempt`` on this host's CPU, at a narrow width (embed
32, 2 blocks, 2 heads (DINO: 1, a head dim the card's kernels take), 16 px
images; the DINO head's hidden width cut from 2048 to ``HEAD_HIDDEN`` so
that a DINO tree stays small; the widths, overrides and loaders are
``fixture_spec.py``'s):

- ``dino_step1``: DINO after one AdamW step (``last_model`` of ``fit(1)``);
- ``dino_step0``: DINO before any step (zero moments), saved by ``_save``;
- ``finetune_frozen``: finetune inside ``freeze_backbone`` (optax's
  ``multi_transform``: moments for the head only), epoch 1 of 2;
- ``finetune_unfrozen``: the same run after the unfreeze (the optimizer
  rebuilt, every leaf trained), epoch 2;
- ``simmim``: SimMIM after one epoch;
- ``supervised_scan_sgd_preempt``: a supervised run with
  ``model.scan_layers`` and SGD with momentum, preempted inside its second
  epoch (``preempt_model``).

``digests.json`` records, for each fixture, every leaf of orbax's own
``PyTreeCheckpointer().restore`` (by dotted key path): its dtype, shape and
the sha256 of its bytes. ``tests/test_torch_orbax.py`` holds the port's
reader to these digests and to a fresh orbax restore; ``chip_smoke.py``
holds the reader to the digests on the card's machine, which has neither
orbax nor tensorstore.

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixtures/make_fixtures.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(HERE))

from fixture_spec import (DINO, HEAD_HIDDEN, IMG, SIMMIM, SUPERVISED,  # noqa: E402
                          leaf_digests, loaders)


def narrow_jax_head():
    """The JAX package's DINO head at :data:`HEAD_HIDDEN` hidden features
    (its default 2048 would make each DINO tree tens of MB)."""
    from vit_ssl_tpu.models import dino

    if dino.DINOHead.__name__ != "NarrowDINOHead":
        class NarrowDINOHead(dino.DINOHead):
            hidden_dim: int = HEAD_HIDDEN

        dino.DINOHead = NarrowDINOHead


def jax_trainer(mode, overrides, kind, run_dir):
    import jax

    from vit_ssl_tpu.config import compose
    from vit_ssl_tpu.models.builder import build_model
    from vit_ssl_tpu.train.trainers.dino import DINOTrainer
    from vit_ssl_tpu.train.trainers.simmim import SimMIMTrainer
    from vit_ssl_tpu.train.trainers.supervised import SupervisedTrainer
    from vit_ssl_tpu.utils.history import TrainingHistory

    TrainingHistory.vizualize = lambda self, num_epochs=None: None
    config = compose(str(REPO / "configs"), mode, overrides)
    bundle = build_model(config)
    bundle.init_fn = jax.jit(bundle.init_fn)
    cls = {"dino": DINOTrainer, "simmim": SimMIMTrainer}.get(mode, SupervisedTrainer)
    train, val = loaders(kind)
    return cls(bundle, str(run_dir), config, train, val, None)


def dino_pth(path):
    """A DINO checkpoint at the finetune's width, as a reference ``.pth``."""
    import jax
    import numpy as np

    from vit_ssl_tpu.models.dino import DINONetwork
    from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch, save_torch_checkpoint

    net = DINONetwork(num_blocks=2, input_shape=(3, IMG, IMG), embed_dim=32, patch_size=8,
                      num_heads=2, mlp_dim=64, output_dim=16)
    trees = [net.init(jax.random.PRNGKey(seed), np.zeros((1, IMG, IMG, 3)))["params"]
             for seed in (1, 2)]
    save_torch_checkpoint(path, dino_params_to_torch(*trees, np.zeros((1, 16), np.float32)))


def keep(run_dir, name, fixture):
    """Copy ``<run_dir>/<name>`` into the fixture ``fixture``."""
    target = HERE / fixture
    shutil.rmtree(target, ignore_errors=True)
    shutil.copytree(Path(run_dir) / name, target)


def make(tmp):
    from vit_ssl_tpu.utils.preempt import PreemptionRequested

    narrow_jax_head()
    t = jax_trainer("dino", DINO, "dino", tmp / "dino0")
    t._save("last_model", 0, {})
    t._join_pending_save()
    keep(tmp / "dino0", "last_model", "dino_step0")

    t = jax_trainer("dino", DINO + ["training.num_epochs=1"], "dino", tmp / "dino1")
    t.train_loader.n = 1  # one step
    t.fit(1)
    keep(tmp / "dino1", "last_model", "dino_step1")

    pth = str(tmp / "dino.pth")
    dino_pth(pth)
    finetune = SUPERVISED + ["training.extended_transfer=true",
                             "training.freeze_backbone=true", "+freeze_backbone_epochs=2",
                             f"training.pretrained_path={pth}"]
    t = jax_trainer("finetune", finetune, "labeled", tmp / "finetune")
    t.fit(1)
    keep(tmp / "finetune", "last_model", "finetune_frozen")
    t.start_epoch = 1
    t.fit(1)  # epoch 2 unfreezes
    keep(tmp / "finetune", "last_model", "finetune_unfrozen")

    t = jax_trainer("simmim", SIMMIM, "images", tmp / "simmim")
    t.fit(1)
    keep(tmp / "simmim", "last_model", "simmim")

    sgd = SUPERVISED + ["model.scan_layers=true", "training.optimizer.name=SGD",
                        "+training.optimizer.params.momentum=0.9",
                        "training.fault_inject_preempt_step=3"]
    t = jax_trainer("supervised", sgd, "labeled", tmp / "scan")
    try:
        t.fit(2)
        raise RuntimeError("the injected preemption did not fire")
    except PreemptionRequested as exc:
        t.save_preempt(exc)
    keep(tmp / "scan", "preempt_model", "supervised_scan_sgd_preempt")


def digests():
    import orbax.checkpoint as ocp

    out = {}
    for fixture in sorted(p.name for p in HERE.iterdir() if (p / "tree").is_dir()):
        restored = ocp.PyTreeCheckpointer().restore(str(HERE / fixture / "tree"))
        out[fixture] = leaf_digests(restored)
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    with tempfile.TemporaryDirectory() as tmp:
        make(Path(tmp))
    with open(HERE / "digests.json", "w") as f:
        # one fixture a line
        f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
                                    for k, v in sorted(digests().items())) + "\n}\n")
    total = sum(f.stat().st_size for f in HERE.rglob("*") if f.is_file())
    print(f"wrote {HERE} ({total} bytes)")


if __name__ == "__main__":
    main()
