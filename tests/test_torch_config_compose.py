"""The port's config engine (``vit_ssl_tpu_torch.config``) against the JAX
package's, on the CPU: the YAML reader on every file of ``configs/``,
composition of every root with overrides, multirun expansion, validation,
and the run config the entry point saves (read back through PyYAML and the
JAX reader)."""

import datetime as real_datetime
import importlib
import json
import os
import types
from pathlib import Path

import pytest
import yaml

from vit_ssl_tpu import config as jax_config
from vit_ssl_tpu_torch import config as port_config
from vit_ssl_tpu_torch.config import yaml_io
from vit_ssl_tpu_torch.train.__main__ import save_run_config

# the modules (the packages export a function under the same name)
jax_compose_mod = importlib.import_module("vit_ssl_tpu.config.compose")
port_compose_mod = importlib.import_module("vit_ssl_tpu_torch.config.compose")
REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
YAML_FILES = sorted(CONFIGS.rglob("*.yaml"))
ROOTS = sorted(p.stem for p in CONFIGS.glob("*.yaml"))


def _same(a, b):
    """Equal values, equal types and equal key order."""
    assert a == b
    assert json.dumps(a, default=repr) == json.dumps(b, default=repr)
    assert repr(a) == repr(b)


@pytest.mark.parametrize("path", YAML_FILES, ids=[str(p.relative_to(CONFIGS))
                                                  for p in YAML_FILES])
def test_reader_matches_jax_load_yaml(path):
    _same(yaml_io.load(path), jax_config.load_yaml(path))


SCALARS = ["1e-6", "1.0e-3", "-2", "0x1F", "0o7", "017", "1_000", "1:30", ".5",
           "-.inf", ".nan", "true", "False", "yes", "off", "~", "null", "",
           "'quoted'", '"tab\\there"', "''", "[0.5, 1.0]", "['eval_knn', 'x y']",
           "{}", "[]", "{a: 1, b: [2, 3]}", "${data.img_size}",
           "./experiments/${training.type}/${now:%Y-%m-%d_%H_%M_%S}",
           "2024-01-31", "2001-12-14t21:59:43.10-05:00", "a #comment", "a#b",
           "/tmp/a b", "x,y", "a: b", "- a"]


@pytest.mark.parametrize("text", SCALARS)
def test_override_values_coerce_as_jax(text):
    got = port_compose_mod._coerce_scalar(text)
    want = jax_compose_mod._coerce_scalar(text)
    if isinstance(want, float) and want != want:  # nan
        assert got != got
    else:
        _same(got, want)


@pytest.mark.parametrize("text,where", [
    ("a: &x 1\n", ":1:"), ("a: *x\n", ":1:"), ("a: !!str 1\n", ":1:"),
    ("a: |\n  x\n", ":1:"), ("a: 1\n---\nb: 2\n", ":2:"),
    ("a: one\n  two\n", ":2:"), ("a:\n\t- 1\n", ":2:"), ("a: b: c\n", ":1:"),
    ("a: [1, 2\n", ":1:"), ("? a\n: 1\n", ":1:"),
])
def test_reader_refuses_outside_its_subset(text, where):
    with pytest.raises(yaml_io.YAMLError, match=rf"cfg\.yaml{where}"):
        yaml_io.loads(text, "cfg.yaml")


class _FixedNow(real_datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture
def fixed_now(monkeypatch):
    """``${now:...}`` at one instant in both composers."""
    fake = types.SimpleNamespace(datetime=_FixedNow)
    monkeypatch.setattr(jax_compose_mod, "datetime", fake)
    monkeypatch.setattr(port_compose_mod, "datetime", fake)


GROUP_OVERRIDES = {
    "dino": ["dino@transforms.locals=globals", "base@model=model_vit_b"],
    "supervised": ["supervised@transforms.val=train_transforms"],
    "simmim": ["simmim@metrics=metrics", "base@parallel=parallel"],
    "finetune": ["finetune@transforms.train=val_transforms"],
    "vit_b_imagenet": ["base@model=model_vit_l"],
}
DOTLIST = ["training.num_epochs=3", "training.warmup_final_learning_rate=1e-4",
           "data.img_size=64", "eval.mode=[eval_knn,eval_linear]",
           "+training.note='a b'", "~parallel.remat", "+base@extra=parallel"]


def _compose_both(root, overrides):
    def one(cfg_mod):
        try:
            return cfg_mod.to_container(cfg_mod.compose(CONFIGS, root, overrides))
        except ValueError as e:
            return ("raised", type(e).__name__, str(e))
    return one(port_config), one(jax_config)


@pytest.mark.parametrize("kind", ["plain", "dotlist", "groups"])
@pytest.mark.parametrize("root", ROOTS)
def test_compose_matches_jax(root, kind, fixed_now):
    overrides = {"plain": [], "dotlist": DOTLIST,
                 "groups": GROUP_OVERRIDES.get(root, []) + DOTLIST[:2]}[kind]
    got, want = _compose_both(root, overrides)
    assert not isinstance(want, tuple), want
    _same(got, want)


def test_compose_run_dir_and_errors_match_jax(fixed_now):
    got, want = _compose_both("dino", [])
    assert got["hydra"]["run"]["dir"] == "./experiments/dino/2026-01-02_03_04_05"
    _same(got, want)
    for bad in (["dino@eval=nope"], ["dino=data"], ["+dino@x=nope"]):
        got, want = _compose_both("dino", bad)
        _same(got, want)
        assert got[0] == "raised"


@pytest.mark.parametrize("overrides", [
    ["a=1,2", "b=x", "c=[1,2]", "d='u,v'"], ["training.lr=1e-4,1e-3", "dino@x=a,b"],
    ["~a", "b"], [],
])
def test_expand_multirun_matches_jax(overrides):
    assert port_config.expand_multirun(overrides) == jax_config.expand_multirun(overrides)


def test_multirun_sweeps_two_jobs(tmp_path, monkeypatch):
    """The entry point's ``-m`` with a comma list runs one job per value
    under ``multirun/<date>/<time>/<idx>`` (relative to the working
    directory), each with its value, and records the sweep in
    ``multirun.yaml`` (the metric plots skipped)."""
    from make_synthetic_data import make
    from vit_ssl_tpu_torch.train.__main__ import main
    from vit_ssl_tpu_torch.utils.history import TrainingHistory

    data_root = make(str(tmp_path / "synth"), n=12, size=16, num_classes=3)
    monkeypatch.setattr(TrainingHistory, "vizualize", lambda self, n=None: None)
    monkeypatch.chdir(tmp_path)
    runs = main(["-m", "--config-path", str(CONFIGS), "--config-name", "dino",
                 "--device", "cpu", f"data.data_dir={data_root}/unlabeled_images",
                 "data.img_size=16", "data.local_img_size=8", "model.embed_dim=32",
                 "model.num_heads=2", "model.num_blocks=2", "model.mlp_dim=64",
                 "model.output_dim=32", "training.batch_size=4", "eval.interval=0",
                 "data.num_workers=0", "training.num_epochs=1",
                 "training.warmup_final_learning_rate=1e-4,1e-3"])
    assert [os.path.basename(r) for r in runs] == ["0", "1"]
    rates = [json.loads((Path(r) / "last_model" / "metadata.json").read_text())
             ["config"]["training"]["warmup_final_learning_rate"] for r in runs]
    assert rates == [1e-4, 1e-3]
    sweep = yaml_io.load(os.path.join(os.path.dirname(runs[0]), "multirun.yaml"))
    assert sweep["n_jobs"] == 2


BROKEN = [
    ["training.type=bogus"], ["~training.batch_size"], ["metrics=[Bogus]"],
    ["parallel.tp=0"], ["parallel.fsdp=true", "parallel.tp=2"],
    ["~model.output_dim"], ["~training.student_temp"],
    ["model.scan_layers=true", "model.moe_experts=2"],
    ["model.moe_experts=2"], ["parallel.ep=2"],
    ["eval.interval=1", "eval.data_dir=/nonexistent"],
]


@pytest.mark.parametrize("overrides", BROKEN, ids=[" ".join(o) for o in BROKEN])
def test_validation_refuses_as_jax(overrides):
    def errors(cfg_mod):
        cfg = cfg_mod.compose(CONFIGS, "dino", overrides)
        with pytest.raises(cfg_mod.ConfigValidationError) as info:
            cfg_mod.validate_train_config(cfg)
            cfg_mod.preflight_eval_data(cfg)
        return str(info.value)
    assert errors(port_config) == errors(jax_config)


def test_validation_accepts_the_roots():
    for root in ("dino", "supervised", "simmim", "vit_b_imagenet"):
        cfg = port_config.compose(CONFIGS, root, ["eval.interval=0"])
        port_config.validate_train_config(cfg)
        port_config.preflight_eval_data(cfg)


def test_saved_run_config_reads_back(tmp_path, fixed_now):
    """``.hydra/config.yaml`` reads back, through PyYAML's safe_load, the
    JAX reader and the port's, to the composed config without ``hydra``;
    ``overrides.yaml`` to the override list."""
    overrides = ["training.num_epochs=3", "training.lr_final=1e-6",
                 "+training.note=1e-6", "+training.flag='true'", "+training.empty=''",
                 "+training.odd='a: b #c'", "data.data_dir=/tmp/x y"]
    cfg = port_config.compose(CONFIGS, "dino", overrides)
    save_run_config(cfg, overrides, str(tmp_path))
    want = port_config.to_container(cfg)
    want.pop("hydra")
    assert want["training"]["note"] == 1e-6 and want["training"]["flag"] == "true"
    path = tmp_path / ".hydra" / "config.yaml"
    for read in (lambda p: yaml.safe_load(p.read_text()), jax_config.load_yaml,
                 yaml_io.load):
        _same(read(path), want)
        _same(read(tmp_path / ".hydra" / "overrides.yaml"), overrides)


@pytest.mark.parametrize("value", [
    {"s": ["1e-6", "true", "null", "", " x", "a: b", "#x", "-x", "- x", "[a]",
           "{a}", "x:", "%x", "it's", 'say "hi"', "tab\there", "2024-01-31",
           "0x10", "1_0", "=", "<<", "~", "ünï"]},
    {"f": [1e-6, 1e-300, 3.0, -0.5, float("inf"), -float("inf"), 123456789.125]},
    {"n": [0, -7, 2**40, True, False, None]},
    {"nest": {"empty_d": {}, "empty_l": [], "l": [[1, 2], [], [{"a": []}]],
              "d": [{"x": 1, "y": {"z": [1]}}, {}]}},
    [1, "two", {"three": 3}],
])
def test_writer_round_trips(value):
    text = yaml_io.dumps(value)
    _same(yaml.safe_load(text), value)
    _same(yaml_io.loads(text), value)
    _same(yaml.load(text, Loader=jax_compose_mod._Loader), value)
