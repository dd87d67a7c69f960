"""Preemption-safe training in the port (``vit_ssl_tpu_torch.utils.preempt``,
``BaseTrainer.save_preempt``/``resume_from``, and the flow of
``python -m vit_ssl_tpu_torch.train``), on the CPU.

- The signal sets the flag; install is idempotent; uninstall restores the
  previous handler.
- ``training.fault_inject_preempt_step`` ends the CLI in ``SystemExit(75)``
  with ``preempt_model``'s metadata keys those JAX's ``save_preempt``
  writes for the same trainer state.
- A preempted and resumed run ends bit-equal to a straight one (every
  parameter, optimizer moment, step; DINO's teacher and center): the
  supervised and SimMIM runs resumed with
  ``training.resume_from_checkpoint``, DINO with
  ``training.step_granular_schedules=true`` rerun with
  ``training.auto_resume=true`` (so the schedules' totals stay).
- An ``auto_resume`` retry loop converges bit-equal and removes
  ``preempt_model``; a mismatched skip epoch is dropped; a real SIGTERM to
  the CLI in a subprocess ends in exit 75 (under a timeout).
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from make_synthetic_data import make

from vit_ssl_tpu.train.trainers import base as jax_base
from vit_ssl_tpu_torch.train.__main__ import main
from vit_ssl_tpu_torch.train.trainers.base import BaseTrainer
from vit_ssl_tpu_torch.utils import preempt
from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("synth")), n=24, size=32, num_classes=3)


@pytest.fixture(autouse=True)
def _clean_flag(monkeypatch):
    """A clear flag before and no handler after each test; two CPU threads
    and no end-of-fit metric plots (compared nowhere here) for the
    in-process runs (the suite runs beside other workers)."""
    from vit_ssl_tpu_torch.utils.history import TrainingHistory

    monkeypatch.setattr(TrainingHistory, "vizualize", lambda self, num_epochs=None: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    preempt.clear_preemption()
    yield
    preempt.uninstall_preemption_handler()
    torch.set_num_threads(threads)


def _tiny(run_dir, extra=()):
    return ["data.img_size=16", "data.num_workers=0",
            "model.embed_dim=32", "model.num_heads=4", "model.num_blocks=1",
            "model.mlp_dim=64", "model.patch_size=8", "training.batch_size=8",
            "training.plain_logging=true", "eval.interval=0",
            f"hydra.run.dir={run_dir}", *extra]


def _args(mode, data_root, run_dir, extra=()):
    """Each mode's CLI arguments; warmup covers every step run here, so the
    lr depends on the step only (a resumed run's num_epochs counts the
    epochs it runs)."""
    if mode == "supervised":
        head = ["--config-name", "supervised", f"data.data_dir={data_root}/train_images",
                f"data.data_csv={data_root}/train_labels.json", "model.num_classes=3"]
    elif mode == "simmim":
        head = ["--config-name", "simmim", f"data.data_dir={data_root}/unlabeled_images"]
    else:
        head = ["--config-name", "dino", f"data.data_dir={data_root}/unlabeled_images",
                "data.local_img_size=8", "model.output_dim=32",
                "training.num_all_views=3", "training.num_global_views=2",
                "training.step_granular_schedules=true"]
    return ["--device", "cpu"] + head + ["training.warmup_epochs=3",
                                         *_tiny(run_dir, extra)]


def _assert_bit_equal(got, want, where="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bit_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def _last(run_dir):
    return load_checkpoint(os.path.join(run_dir, "last_model"))


def test_signal_sets_flag_and_uninstall_restores():
    previous = signal.getsignal(signal.SIGUSR1)
    preempt.install_preemption_handler()
    assert not preempt.preemption_requested()
    os.kill(os.getpid(), signal.SIGUSR1)
    for _ in range(200):
        if preempt.preemption_requested():
            break
        time.sleep(0.01)
    assert preempt.preemption_requested()
    preempt.uninstall_preemption_handler()
    assert not preempt.preemption_requested()
    assert signal.getsignal(signal.SIGUSR1) is previous


def test_install_is_idempotent():
    previous = signal.getsignal(signal.SIGTERM)
    preempt.install_preemption_handler()
    preempt.install_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is preempt._handler
    preempt.uninstall_preemption_handler()
    preempt.uninstall_preemption_handler()  # a second uninstall does nothing
    assert signal.getsignal(signal.SIGTERM) is previous
    assert preempt.PREEMPT_EXIT_CODE == 75


def _jax_metadata_keys(tmp_path, best_acc):
    """The metadata keys JAX's ``save_preempt`` writes for a supervised
    trainer with a best accuracy (its checkpoint writer replaced by a
    recorder)."""
    written = {}

    class Trainer:
        save_path = str(tmp_path)
        config = {"training": {"type": "supervised"}}
        best_val_loss = math.inf
        best_val_acc = best_acc

        class bundle:
            mode = "supervised"

        def _join_pending_save(self):
            pass

        def _state_tree(self):
            return {}

        def _best_extra(self):
            return jax_base.BaseTrainer._best_extra(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_base, "save_checkpoint",
               lambda path, tree, metadata: written.update(metadata))
    mp.setattr(jax_base, "to_container", lambda c: c)
    try:
        jax_base.BaseTrainer.save_preempt(Trainer(), preempt.PreemptionRequested(2, 1))
    finally:
        mp.undo()
    return set(written)


@pytest.mark.parametrize("mode", ["supervised", "simmim"])
def test_preempt_and_resume_is_bit_exact(mode, data_root, tmp_path):
    """3 train batches an epoch: the fault after 4 lands at epoch 2, batch
    1; ``preempt_model`` holds epoch 1, preempt_epoch 2, batches done 1 and
    JAX's metadata keys; the resumed run's last_model equals the straight
    run's."""
    straight = str(tmp_path / "straight")
    main(_args(mode, data_root, straight, ["training.num_epochs=2"]))
    want, want_meta = _last(straight)
    assert want_meta["epoch"] == 2

    run = str(tmp_path / "preempted")
    with pytest.raises(SystemExit) as exc:
        main(_args(mode, data_root, run, ["training.num_epochs=2",
                                          "training.fault_inject_preempt_step=4"]))
    assert exc.value.code == preempt.PREEMPT_EXIT_CODE
    assert signal.getsignal(signal.SIGTERM) is not preempt._handler  # uninstalled
    ckpt = os.path.join(run, "preempt_model")
    meta = json.loads(Path(ckpt, "metadata.json").read_text())
    assert (meta["epoch"], meta["preempt_epoch"], meta["preempt_batches_done"]) == (1, 2, 1)
    assert meta["mode"] == mode and meta["config"]["training"]["type"] == mode
    if mode == "supervised":
        assert set(meta) == _jax_metadata_keys(tmp_path, meta["best_val_acc"])

    preempt.clear_preemption()
    main(_args(mode, data_root, run, ["training.num_epochs=1",
                                      f"training.resume_from_checkpoint={ckpt}"]))
    got, got_meta = _last(run)
    assert got_meta["epoch"] == 2
    _assert_bit_equal(got, want)


def test_dino_step_granular_auto_resume_is_bit_exact(data_root, tmp_path):
    """DINO with per-step schedules: the preempted run, rerun with
    auto_resume, continues each schedule at its batch's true position;
    student, teacher, center, moments and step equal the straight run's."""
    straight = str(tmp_path / "straight")
    main(_args("dino", data_root, straight, ["training.num_epochs=2"]))
    want, _ = _last(straight)

    run = str(tmp_path / "preempted")
    args = _args("dino", data_root, run, ["training.num_epochs=2",
                                          "training.auto_resume=true",
                                          "training.fault_inject_preempt_step=4"])
    with pytest.raises(SystemExit):
        main(list(args))
    meta = json.loads(Path(run, "preempt_model", "metadata.json").read_text())
    assert (meta["preempt_epoch"], meta["preempt_batches_done"]) == (2, 1)
    assert "best_val_score" in meta
    preempt.clear_preemption()
    main(list(args))
    got, meta = _last(run)
    assert meta["epoch"] == 2
    _assert_bit_equal(got, want)


def test_auto_resume_loop_converges_and_removes_preempt_model(data_root, tmp_path):
    """The same command retried on exit 75 reaches num_epochs in all, bit-equal
    to a straight run; the consumed preempt_model is gone."""
    straight = str(tmp_path / "straight")
    main(_args("supervised", data_root, straight, ["training.num_epochs=3"]))
    want, _ = _last(straight)
    run = str(tmp_path / "loop")
    args = _args("supervised", data_root, run,
                 ["training.num_epochs=3", "training.auto_resume=true",
                  "training.fault_inject_preempt_step=4"])
    attempts = 0
    while attempts < 6:
        attempts += 1
        try:
            main(list(args))
            break
        except SystemExit as e:
            assert e.code == preempt.PREEMPT_EXIT_CODE
            preempt.clear_preemption()
    else:
        pytest.fail("the auto_resume loop never completed")
    assert attempts == 3  # epoch 2 batch 1, epoch 3 batch 2, then the end
    got, meta = _last(run)
    assert meta["epoch"] == 3
    assert not os.path.isdir(os.path.join(run, "preempt_model"))
    _assert_bit_equal(got, want)


def test_finetune_preempted_inside_the_unfreeze_epoch_resumes_bit_exact(data_root,
                                                                      tmp_path):
    """A finetune frozen until epoch 2, preempted inside epoch 2 (after the
    unfreeze rebuilt the optimizer) and auto-resumed: the resume unfreezes
    before loading the moments and not again, so the run ends bit-equal to
    a straight one."""
    source = str(tmp_path / "source")
    main(_args("supervised", data_root, source, ["training.num_epochs=1"]))
    extra = ["training.num_epochs=2", "training.freeze_backbone=true",
             "+freeze_backbone_epochs=2",
             f"training.pretrained_path={source}/best_model"]

    def finetune(run_dir, more=()):
        args = _args("supervised", data_root, run_dir, [*extra, *more])
        args[args.index("supervised")] = "finetune"
        main(args)

    straight = str(tmp_path / "straight")
    finetune(straight)
    want, _ = _last(straight)
    run = str(tmp_path / "preempted")
    more = ["training.auto_resume=true", "training.fault_inject_preempt_step=4"]
    with pytest.raises(SystemExit):
        finetune(run, more)
    meta = json.loads(Path(run, "preempt_model", "metadata.json").read_text())
    assert (meta["preempt_epoch"], meta["preempt_batches_done"]) == (2, 1)
    preempt.clear_preemption()
    finetune(run, more)
    got, meta = _last(run)
    assert meta["epoch"] == 2
    _assert_bit_equal(got, want)


def test_mismatched_skip_epoch_is_dropped():
    class Dummy:
        _mid_epoch_skip = (2, 5)

    d = Dummy()
    assert BaseTrainer._consume_mid_epoch_skip(d, 3) == 0  # another epoch: dropped
    assert d._mid_epoch_skip is None
    d._mid_epoch_skip = (2, 5)
    assert BaseTrainer._consume_mid_epoch_skip(d, 2) == 5
    assert BaseTrainer._consume_mid_epoch_skip(d, 2) == 0  # one-shot


def test_sigterm_saves_preempt_model_and_exits_75(data_root, tmp_path):
    """The CLI in a subprocess: SIGTERM once epoch 1 is checkpointed ends it
    with exit 75 and a preempt_model of a later epoch; every wait has a
    timeout and the process is killed on the way out."""
    run = str(tmp_path / "sig")
    args = _args("supervised", data_root, run, ["training.num_epochs=500"])
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "vit_ssl_tpu_torch.train", *args],
                            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        last = os.path.join(run, "last_model")
        while time.time() < deadline and not os.path.isdir(last):
            if proc.poll() is not None:
                pytest.fail(f"training exited early: rc={proc.returncode}")
            time.sleep(0.1)
        assert os.path.isdir(last), "epoch 1 never finished"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == preempt.PREEMPT_EXIT_CODE
    meta = json.loads(Path(run, "preempt_model", "metadata.json").read_text())
    assert meta["preempt_epoch"] >= 2
