"""The port's metrics, best-parameter checkpoints, reference-checkpoint
ingestion and pretrained backbones (smow_net_tpu_torch/train) against the
JAX package on the CPU.

The JAX models are only shaped (`jax.eval_shape` of init at 64x64, shared
by a module fixture) and filled with numpy-seeded values; no JAX step is
compiled. Pretrained state_dicts are numpy-seeded in torchvision's resnet18
and mobilenet_v2 layouts, with the shapes written out here: nothing is
fetched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models import get_model as get_jax_model
from smow_net_tpu.train import ingest as jax_ingest
from smow_net_tpu.train import metrics as jax_metrics
from smow_net_tpu.train import pretrained as jax_pretrained
from smow_net_tpu_torch.models import get_model
from smow_net_tpu_torch.train import checkpoint, ingest, metrics, pretrained
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.trainer import create_train_state, make_optimizer
from test_torch_smow_net import _seeded
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

SIZE = 64
MODELS = ("smow_net", "smow_net_lw")


def _variables(model, seed):
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    rng = np.random.default_rng(seed)
    return {"params": _seeded(shapes["params"], rng),
            "batch_stats": _seeded(shapes["batch_stats"], rng)}


@pytest.fixture(scope="module")
def setups():
    """Per model: two numpy-seeded JAX variable trees (0: the weights under
    test, 1: a template that every loader must overwrite)."""
    out = {}
    for name in MODELS:
        model = get_jax_model(name)
        out[name] = [_variables(model, seed) for seed in (0, 1)]
    return out


def _port(name, variables):
    model = get_model(name, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model=name))
    return model


def _assert_equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- metrics

def test_cm2f1_and_meter_match_jax():
    rng = np.random.default_rng(0)
    ours, theirs = metrics.ConfuseMatrixMeter(), jax_metrics.ConfuseMatrixMeter()
    for _ in range(5):
        cm = rng.integers(0, 10 ** 6, (2, 2)).astype(np.float32)
        assert abs(metrics.cm2F1(cm) - jax_metrics.cm2F1(cm)) <= 1e-12
        got = ours.update_cm(torch.from_numpy(cm))
        assert abs(got - theirs.update_cm(cm)) <= 1e-12
    got, want = ours.get_scores(), theirs.get_scores()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    ours.clear()
    assert not ours.sum.any()
    with pytest.raises(ValueError):
        metrics.ConfuseMatrixMeter(3)


# ---------------------------------------------------------------- checkpoints

def test_best_params_round_trip(tmp_path, setups):
    model = _port("smow_net_lw", setups["smow_net_lw"][0])
    with torch.no_grad():                # buffers that a train run moves
        for name, buf in model.named_buffers():
            if name.endswith("num_batches_tracked"):
                buf.fill_(3)
    path = str(tmp_path / "best")
    checkpoint.save_best_params(path, model)
    other = _port("smow_net_lw", setups["smow_net_lw"][1])
    checkpoint.restore_best_params(path, other)
    want, got = model.state_dict(), other.state_dict()
    assert set(got) == set(want)
    _assert_equal(got, want, want)


def test_reset_metrics_zeroes_the_device_sums():
    model = torch.nn.Linear(2, 1)
    opt = make_optimizer(lambda count: 1e-3)(model.parameters())
    state = create_train_state(model, opt)
    state.cm += 4.0
    state.loss_sum += 2.5
    state.loss_count += 1.0
    state.reset_metrics()
    assert not state.cm.any() and float(state.loss_sum) == 0 and float(state.loss_count) == 0


# ---------------------------------------------------------------- ingestion

@pytest.mark.parametrize("name", MODELS)
def test_ingest_reference_checkpoint_matches_jax(tmp_path, setups, name):
    """A DataParallel .pth of the port's state_dict: the port restores it
    bitwise, and the JAX package's strict ingestion accepts it and writes
    back the same tensors, so the port's keys are the reference's."""
    model = _port(name, setups[name][0])
    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith("num_batches_tracked"):
                buf.fill_(7)
    saved = model.state_dict()
    path = str(tmp_path / "best.pth")
    torch.save({"module." + k: v for k, v in saved.items()}, path)

    fresh = _port(name, setups[name][1])
    assert ingest.ingest_torch_checkpoint(name, path, fresh) is fresh
    _assert_equal(fresh.state_dict(), saved, saved)

    variables = jax_ingest.ingest_torch_checkpoint(name, path, setups[name][1], strict=True)
    written = state_dict_from_jax(variables, model=name)
    # the JAX tree has no BN step counter: state_dict_from_jax writes 0 there
    counters = {k for k in saved if k.endswith("num_batches_tracked")}
    assert set(written) == set(saved) and counters
    _assert_equal(written, saved, set(saved) - counters)
    assert all(int(written[k]) == 0 for k in counters)


def test_load_torch_state_dict_forms(tmp_path, setups):
    model = _port("smow_net_lw", setups["smow_net_lw"][0])
    want = model.state_dict()
    forms = {"raw": want, "dp": {"module." + k: v for k, v in want.items()},
             "wrapper": {"state_dict": want, "epoch": 3}, "module": model}
    for form, obj in forms.items():
        path = str(tmp_path / f"{form}.pth")
        torch.save(obj, path)
        got = ingest.load_torch_state_dict(path)
        assert set(got) == set(want), form
        _assert_equal(got, want, want)


def test_ingest_refuses_unported_and_unknown_models():
    model = torch.nn.Linear(1, 1)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        ingest.ingest_torch_checkpoint("fc_ef", {}, model)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        ingest.ingest_torch_checkpoint("bit", {}, model)
    with pytest.raises(ValueError):
        ingest.ingest_torch_checkpoint("no_such_model", {}, model)
    assert ingest.supported_models() == ("smow_net", "smow_net_lw", "change_mamba", "cd_mamba",
                                         "rs_mamba")


# ---------------------------------------------------------------- pretrained

def _bn(sd, prefix, c, rng):
    sd[prefix + ".weight"] = 1.0 + 0.1 * rng.normal(size=c)
    sd[prefix + ".bias"] = 0.1 * rng.normal(size=c)
    sd[prefix + ".running_mean"] = 0.1 * rng.normal(size=c)
    sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, size=c)
    sd[prefix + ".num_batches_tracked"] = 5


def _resnet18(rng):
    """torchvision resnet18's state_dict layout."""
    sd = {"conv1.weight": rng.normal(size=(64, 3, 7, 7))}
    _bn(sd, "bn1", 64, rng)
    cin = 64
    for li, c in enumerate((64, 128, 256, 512), 1):
        for bi in range(2):
            p = f"layer{li}.{bi}"
            sd[f"{p}.conv1.weight"] = rng.normal(size=(c, cin if bi == 0 else c, 3, 3))
            _bn(sd, f"{p}.bn1", c, rng)
            sd[f"{p}.conv2.weight"] = rng.normal(size=(c, c, 3, 3))
            _bn(sd, f"{p}.bn2", c, rng)
            if bi == 0 and li > 1:
                sd[f"{p}.downsample.0.weight"] = rng.normal(size=(c, cin, 1, 1))
                _bn(sd, f"{p}.downsample.1", c, rng)
        cin = c
    sd["fc.weight"], sd["fc.bias"] = rng.normal(size=(1000, 512)), rng.normal(size=1000)
    return sd


def _mobilenet_v2(rng):
    """torch-hub mobilenet_v2's state_dict layout: (expand, out, repeats,
    stride) per stage, then the 1280-wide features.18 and the classifier."""
    sd = {"features.0.0.weight": rng.normal(size=(32, 3, 3, 3))}
    _bn(sd, "features.0.1", 32, rng)
    i, cin = 1, 32
    for t, c, n, _ in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)):
        for _ in range(n):
            hid, p, j = cin * t, f"features.{i}.conv", 0
            if t != 1:
                sd[f"{p}.0.0.weight"] = rng.normal(size=(hid, cin, 1, 1))
                _bn(sd, f"{p}.0.1", hid, rng)
                j = 1
            sd[f"{p}.{j}.0.weight"] = rng.normal(size=(hid, 1, 3, 3))
            _bn(sd, f"{p}.{j}.1", hid, rng)
            sd[f"{p}.{j + 1}.weight"] = rng.normal(size=(c, hid, 1, 1))
            _bn(sd, f"{p}.{j + 2}", c, rng)
            i, cin = i + 1, c
    sd["features.18.0.weight"] = rng.normal(size=(1280, 320, 1, 1))
    _bn(sd, "features.18.1", 1280, rng)
    sd["classifier.1.weight"] = rng.normal(size=(1000, 1280))
    sd["classifier.1.bias"] = rng.normal(size=1000)
    return sd


@pytest.mark.parametrize("name,layout,prefix,suffix", [
    ("smow_net", _resnet18, "resnet.", ".pth"), ("smow_net_lw", _mobilenet_v2, "backbone.", ".npz")])
def test_pretrained_backbone_matches_jax(tmp_path, setups, name, layout, prefix, suffix):
    sd = layout(np.random.default_rng(4))
    path = str(tmp_path / f"pretrained{suffix}")
    if suffix == ".npz":
        np.savez(path, **{k: np.asarray(v, np.float32 if np.ndim(v) else np.int64)
                          for k, v in sd.items()})
    else:
        torch.save({k: torch.tensor(np.asarray(v, np.float32)) if np.ndim(v) else torch.tensor(v)
                    for k, v in sd.items()}, path)
    model = _port(name, setups[name][0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pretrained.load_pretrained_backbone(name, path, model) is model
    got = model.state_dict()

    variables = jax_pretrained.load_pretrained_backbone(name, path, setups[name][0])
    want = state_dict_from_jax(variables, model=name)
    assert set(got) == set(want)
    _assert_equal(got, want, want)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    # every backbone weight, BN scale, bias and statistic moved; nothing else
    expect = {k for k in got if k.startswith(prefix) and not k.endswith("num_batches_tracked")
              and not (name == "smow_net" and ".conv3d_time_" in k)}
    assert moved == expect


def test_pretrained_refuses_models_without_a_recipe(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, w=np.zeros(1, np.float32))
    model = torch.nn.Linear(1, 1)
    for name in ("change_mamba", "cd_mamba"):
        with pytest.raises(ValueError, match="no pretrained-backbone recipe"):
            pretrained.load_pretrained_backbone(name, path, model)
        with pytest.raises(ValueError, match="no pretrained-backbone recipe"):
            jax_pretrained.load_pretrained_backbone(name, path, {"params": {}, "batch_stats": {}})
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        pretrained.load_pretrained_backbone("bit", path, model)
