"""Port: the serving export (train/export.py: `torch.export` of uint8 pixels
-> normalize_image -> forward_train, full and weightless), the custom ops it
traces (`owlvit::pk_fwd`, `owlvit::add_ln_fwd`), `Trainer.evaluate(infer_fn=)`
and the CLI's `export` and `eval --from-export`, at `tiny` in fp32 on the
CPU, where the ops run their plain versions.

Tolerances: a loaded artifact against the eager forward rtol 1e-5 / atol
1e-6 (tests/test_trainer.py's export test); weightless against full 1e-6;
the port's artifact against the JAX package's `load_exported` on one npz
atol 2e-5 / rtol 2e-4 (fp32 through two frameworks, the forward's parity
tolerance); evaluate through an artifact against the direct eval atol 1e-8
(tests/test_trainer.py); the port's CLI metrics against the JAX CLI's atol
1e-6 (tests/test_torch_run.py's eval metrics).
"""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from owlvit_tpu.models import convert as jconvert
from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.train import export as jexport
from owlvit_tpu_torch import cli
from owlvit_tpu_torch.models import convert, get_config, owlvit
from owlvit_tpu_torch.ops import flash_attention as tfa
from owlvit_tpu_torch.ops import fused_ln
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.train import export

CFG = get_config("tiny")
S = CFG.vision.image_size


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, S, S, 3), dtype=np.uint8)


def _eager(model, images):
    with torch.no_grad():
        return owlvit.forward_train(model, CFG.replace(trainable_last_k=None),
                                    normalize_image(torch.from_numpy(images)))


@pytest.fixture(scope="module")
def model():
    return owlvit.init(CFG, torch.Generator().manual_seed(0), num_queries=6)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_export_roundtrip(model, fused, monkeypatch):
    """export_detector -> bytes -> load_exported: the eager forward's boxes
    and sims; under OWLVIT_FUSED_LN=1 the program calls owlvit::add_ln_fwd
    too. The program holds the detector's parameters but not the text
    tower's."""
    monkeypatch.setenv("OWLVIT_FUSED_LN", fused)
    blob = export.export_detector(model, CFG, batch_size=2)
    assert isinstance(blob, bytes) and len(blob) > 1000
    imgs = _images(2)
    got = export.load_exported(blob)(imgs)
    for g, r in zip(got, _eager(model, imgs)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "owlvit.pk_fwd.default" in ops
    assert ("owlvit.add_ln_fwd.default" in ops) == (fused == "1")
    names = set(program.state_dict)
    assert "queries" in names and not any(n.startswith("text.") for n in names)


def test_export_weightless_roundtrip(model, tmp_path):
    """The weightless artifact holds no weights (under half the full one's
    size) and, with the weights bound from the JAX-layout npz the CLI
    writes, gives the full artifact's outputs."""
    full = export.export_detector(model, CFG, batch_size=1)
    blob = export.export_detector_weightless(model, CFG, batch_size=1)
    assert len(blob) < len(full) / 2
    path = str(tmp_path / "params.npz")
    convert.save_params(path, convert.to_jax_tree(model))
    export.save_exported(str(tmp_path / "wl.pt2"), blob)
    imgs = _images(1, seed=1)
    a = export.load_exported(full)(imgs)
    b = export.load_exported_weightless(str(tmp_path / "wl.pt2"), convert.load_params(path),
                                        device="cpu")(imgs)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


def test_to_jax_tree_inverts_load_tree(model):
    """The npz tree the weightless export writes loads back into the same
    parameters, and matches the JAX package's tree layout (the same keys
    and shapes as a JAX init of the same config)."""
    tree = convert.to_jax_tree(model)
    back = convert._state_dict(tree)
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    ref = jconvert.flatten(jax.tree.map(np.asarray, jowlvit.init(
        jax.random.PRNGKey(0), jax_get_config("tiny"), num_queries=6)))
    flat = convert.flatten(tree)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}


@pytest.mark.parametrize("weightless", [False, True])
def test_export_matches_jax_export(weightless):
    """On one set of parameters (a JAX init with a query bank), the port's
    loaded artifact against the JAX package's load_exported(export_detector
    (...)) on the same pixels."""
    tree = jax.tree.map(np.asarray, jowlvit.init(jax.random.PRNGKey(3),
                                                 jax_get_config("tiny"), num_queries=6))
    model, _ = convert.from_jax_tree(tree, CFG)
    imgs = _images(2, seed=2)
    ref = jexport.load_exported(jexport.export_detector(tree, jax_get_config("tiny"),
                                                        batch_size=2))(imgs)
    if weightless:
        fn = export.load_exported_weightless(
            export.export_detector_weightless(model, CFG, batch_size=2), tree, device="cpu")
    else:
        fn = export.load_exported(export.export_detector(model, CFG, batch_size=2))
    for g, r in zip(fn(imgs), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations(dtype):
    """The ops' fake implementations, what torch.export traces: o like q,
    lse [B, H, S] fp32; r and y like x. opcheck holds each against its real
    implementation on the CPU (schema, fake tensor, autograd registration)."""
    with FakeTensorMode() as mode:
        q = mode.from_tensor(torch.empty(2, 9, 128, dtype=dtype))
        o, lse = tfa.pk_fwd(q, q, q, scale=0.125, num_heads=2)
        assert (o.shape, o.dtype) == (q.shape, dtype)
        assert (lse.shape, lse.dtype) == ((2, 2, 9), torch.float32)
        x = mode.from_tensor(torch.empty(2, 5, 256, dtype=dtype))
        w = mode.from_tensor(torch.empty(256))
        r, y = fused_ln.add_ln_fwd(x, x, w, w, 1e-5)
        assert all((t.shape, t.dtype) == (x.shape, dtype) for t in (r, y))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 128, generator=g).to(dtype) for _ in range(3))
    torch.library.opcheck(torch.ops.owlvit.pk_fwd, (q, k, v, 0.125, 2, 7, None))
    torch.library.opcheck(torch.ops.owlvit.pk_fwd, (q, k, v, 0.125, 2, None, 20.0))
    x, h = (torch.randn(2, 5, 256, generator=g).to(dtype) for _ in range(2))
    torch.library.opcheck(torch.ops.owlvit.add_ln_fwd,
                          (x, h, torch.ones(256), torch.zeros(256), 1e-5))


# ------------------------------------------------------------ eval, the CLI


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A config both CLIs load the same weights from (a JAX init with a
    query bank, saved by the JAX package's save_params), the synthetic set,
    and confidence_threshold 0 so that every eval image keeps detections."""
    root = str(tmp_path_factory.mktemp("exportwork"))
    params = jowlvit.init(jax.random.PRNGKey(5), jax_get_config("tiny"), num_queries=9)
    jconvert.save_params(f"{root}/params.npz", jax.tree.map(np.asarray, params))
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"""
data:
  synthetic_root: {root}/synth
  num_train_images: 4
  num_test_images: 6
  max_gt: 8
  synthetic_classes: 3
training:
  batch_size: 2
  top_k: 8
  confidence_threshold: 0.0
model:
  name: tiny
  params_npz: {root}/params.npz
""")
    return root, cfg_path


def _trainer(workdir, **kw):
    from owlvit_tpu_torch.train import Trainer
    from owlvit_tpu_torch.utils.config import load_config

    root, cfg_path = workdir
    return Trainer.from_config(load_config(cfg_path), workdir=root, device="cpu", **kw)


@pytest.mark.parametrize("weightless", [False, True])
def test_evaluate_through_export_matches_direct(workdir, tmp_path, weightless):
    """evaluate(infer_fn=) runs the same postprocess, packing and metric on
    the loaded artifact's outputs: the metrics within 1e-8 of the direct
    eval's and the same kept detections."""
    trainer = _trainer(workdir)
    bs = trainer.cfg.training.batch_size
    direct_dets, via_dets = str(tmp_path / "direct.json"), str(tmp_path / "via.json")
    direct = trainer.evaluate(save_detections=direct_dets)
    if weightless:
        fn = export.load_exported_weightless(
            export.export_detector_weightless(trainer.model, trainer.model_cfg, bs),
            convert.to_jax_tree(trainer.model), device="cpu")
    else:
        fn = export.load_exported(export.export_detector(trainer.model, trainer.model_cfg, bs))
    via = trainer.evaluate(infer_fn=fn, save_detections=via_dets)
    assert set(direct) == set(via)
    for k in direct:
        np.testing.assert_allclose(np.asarray(direct[k]), np.asarray(via[k]), atol=1e-8,
                                   err_msg=k)
    with open(direct_dets) as f, open(via_dets) as g:
        a, b = json.load(f), json.load(g)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x["image_id"], x["category_id"]) == (y["image_id"], y["category_id"])
        np.testing.assert_allclose(x["bbox"] + [x["score"]], y["bbox"] + [y["score"]],
                                   atol=1e-5)


def _metrics(text):
    return json.loads(text[text.index("{\n"):])


def test_cli_export_eval_matches_jax_cli(workdir, capsys):
    """`export --weightless` then `eval --from-export --export-params`,
    through the port's CLI (--device cpu) and the JAX package's on the same
    weights and data: the port's metrics within 1e-8 of its own direct eval
    and within 1e-6 of the JAX CLI's."""
    from owlvit_tpu import cli as jcli

    root, cfg_path = workdir
    base = ["--config", cfg_path, "--workdir", root]
    out = {}
    for side, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        art = os.path.join(root, f"{side}.artifact")
        main(["export", *base, *dev, "--out", art, "--batch-size", "2", "--weightless"])
        text = capsys.readouterr().out
        assert f"wrote {art}.npz" in text and os.path.exists(art)
        main(["eval", *base, *dev, "--from-export", art, "--export-params", f"{art}.npz"])
        text = capsys.readouterr().out
        assert "eval through exported artifact" in text
        out[side] = _metrics(text)
    cli.main(["eval", *base, "--device", "cpu"])
    direct = _metrics(capsys.readouterr().out)
    assert set(out["port"]) == set(out["jax"]) == set(direct)
    for k in direct:
        np.testing.assert_allclose(np.asarray(out["port"][k]), np.asarray(direct[k]),
                                   atol=1e-8, err_msg=k)
        np.testing.assert_allclose(np.asarray(out["port"][k]), np.asarray(out["jax"][k]),
                                   atol=1e-6, err_msg=k)
    # the npz the port writes is the JAX layout: the JAX CLI's weights
    port_tree = convert.flatten(convert.load_params(os.path.join(root, "port.artifact.npz")))
    jax_tree = convert.flatten(convert.load_params(os.path.join(root, "jax.artifact.npz")))
    assert set(port_tree) == set(jax_tree)
    for k in jax_tree:
        np.testing.assert_allclose(port_tree[k], jax_tree[k], atol=0, rtol=0, err_msg=k)


def test_cli_export_full_artifact(workdir, tmp_path, capsys):
    """`export` without --weightless writes one artifact that
    load_exported serves: the eager forward's outputs."""
    root, cfg_path = workdir
    art = str(tmp_path / "full.artifact")
    cli.main(["export", "--config", cfg_path, "--workdir", root, "--device", "cpu",
              "--out", art, "--batch-size", "3"])
    assert f"wrote {art} (" in capsys.readouterr().out
    trainer = _trainer(workdir)
    imgs = _images(3, seed=4)
    for g, r in zip(export.load_exported(art)(imgs), _eager(trainer.model, imgs)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)


def test_cli_export_ema(workdir, tmp_path, capsys, monkeypatch):
    """--ema refuses a config without training.ema_decay, as the JAX CLI
    does; with it, the npz beside the weightless artifact holds the EMA in
    the trainable parameters."""
    root, cfg_path = workdir
    art = str(tmp_path / "ema.artifact")
    argv = ["export", "--config", cfg_path, "--workdir", root, "--device", "cpu",
            "--out", art, "--weightless", "--ema"]
    with pytest.raises(SystemExit, match="training.ema_decay"):
        cli.main(argv)
    ema_cfg = str(tmp_path / "ema.yaml")
    with open(cfg_path) as f, open(ema_cfg, "w") as g:
        g.write(f.read().replace("training:\n", "training:\n  ema_decay: 0.9\n"))
    argv[2] = ema_cfg
    seen = {}
    real = cli._trainer

    def trainer_with_ema(args):  # an EMA that differs from the parameters
        t = real(args)
        for e in t.ema:
            e.add_(0.5)
        seen["ema"] = [e.clone() for e in t.ema]
        names = {id(p): n for n, p in t.model.named_parameters()}
        seen["order"] = [names[id(p)] for p in t.params]
        return t

    monkeypatch.setattr(cli, "_trainer", trainer_with_ema)
    cli.main(argv)
    capsys.readouterr()
    state = convert._state_dict(convert.load_params(f"{art}.npz"))
    for name, e in zip(seen["order"], seen["ema"]):
        assert torch.equal(state[name], e), name


def test_cli_export_runs_on_the_card_by_default(workdir, tmp_path):
    """Without --device, export asks for the card and refuses where there is
    none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root, cfg_path = workdir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["export", "--config", cfg_path, "--workdir", root,
                  "--out", str(tmp_path / "a.artifact")])
