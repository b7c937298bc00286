"""The port's train and test CLIs (smow_net_tpu_torch/cli) end to end on the
CPU: a synthetic set at 64x64, SMOW_Net, fp32, batch 2; two epochs, a
resume to the third, then the test CLI on `best`; and a zoo model (FC-EF)
through both CLIs for one epoch.

Checked: the files and lines the CLIs write, the state `--resume`
restores (bitwise the one `last` holds), the visualisations (decoded by
PIL, equal to the JAX package's test.py `colorize` written by
`cv2.imwrite` for the same prediction and ground truth), and the flags
and devices that raise.
"""

import contextlib
import copy
import importlib.util
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from smow_net_tpu_torch.cli import test as cli_test
from smow_net_tpu_torch.cli import train as cli_train
from smow_net_tpu_torch.data.dataset import (CDDataset, DataLoader, generate_synthetic_dataset,
                                             prefetch_to_device)
from smow_net_tpu_torch.models import get_model
from smow_net_tpu_torch.train.checkpoint import restore_best_params
from smow_net_tpu_torch.train.trainer import make_eval_step
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_test_cli():
    """The repository's test.py (the JAX package's CLI), not the stdlib `test`."""
    spec = importlib.util.spec_from_file_location("smow_jax_test_cli",
                                                  os.path.join(REPO, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_opt(root, out, epochs, *extra):
    return cli_train.parse_option([
        "--model", "smow_net", "--data_dir", root, "--output_dir", out, "--epochs", str(epochs),
        "--batchsize", "2", "--trainsize", "64", "--num_workers", "2", "--device", "cpu",
        *extra])


def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = generate_synthetic_dataset(str(tmp / "data"), n_train=4, n_val=2, size=64, seed=3)
    out = str(tmp / "out")
    first, first_log = _captured(cli_train.main, _train_opt(root, out, 2))
    shutil.copy(os.path.join(out, "last"), str(tmp / "last_epoch2"))
    files = {name: open(os.path.join(out, name)).read()
             for name in ("train.txt", "val.txt", "metrics.jsonl")}

    opt = _train_opt(root, out, 3, "--resume", os.path.join(out, "last"))
    resumed, resume_log = _captured(cli_train.setup, opt)
    restored = {"model": {k: v.clone() for k, v in resumed.model.state_dict().items()},
                "optimizer": copy.deepcopy(resumed.state.optimizer.state_dict())}
    _, fit_log = _captured(cli_train.fit, opt, resumed)

    vis = str(tmp / "vis")
    test_opt = cli_test.parse_option(["--model", "smow_net", "--data_dir", root, "--checkpoint",
                                      os.path.join(out, "best"), "--output_dir", vis,
                                      "--batchsize", "2", "--device", "cpu"])
    (scores, cm), test_log = _captured(cli_test.main, test_opt)
    return dict(root=root, out=out, tmp=tmp, first=first, first_log=first_log, files=files,
                restored=restored, saved=torch.load(str(tmp / "last_epoch2"), weights_only=True),
                resume_log=resume_log + fit_log, vis=vis, scores=scores, cm=cm,
                test_log=test_log)


def test_train_writes_its_files_and_lines(runs):
    assert runs["files"]["train.txt"].splitlines()[0].startswith("Epoch: 1, IoU: ")
    assert len(runs["files"]["train.txt"].splitlines()) == 2
    assert len(runs["files"]["val.txt"].splitlines()) == 2
    records = [json.loads(line) for line in runs["files"]["metrics.jsonl"].splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert set(records[0]) == {"epoch", "train", "val", "train_loss", "time"}
    assert np.isfinite([r["train_loss"] for r in records]).all()
    for name in ("best", "last"):
        assert os.path.isfile(os.path.join(runs["out"], name))
    log = runs["first_log"]
    assert "Epoch [001/002], Step [0002/0002], Loss: " in log
    assert "Epoch 2 val:   {'acc': " in log
    assert runs["first"].state.optimizer.count == 4


def test_resume_restores_last_bitwise(runs):
    log = runs["resume_log"]
    assert f"resumed from {os.path.join(runs['out'], 'last')} at epoch 3" in log
    saved, restored = runs["saved"], runs["restored"]
    assert saved["extra"]["epoch"] == 2
    assert set(restored["model"]) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert restored["optimizer"]["count"] == saved["optimizer"]["count"] == 4
    moments = restored["optimizer"]["inner"]["state"]
    for i, st in saved["optimizer"]["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(moments[i][k], v), (i, k)
    train_lines = open(os.path.join(runs["out"], "train.txt")).read().splitlines()
    assert len(train_lines) == 3 and train_lines[2].startswith("Epoch: 3, IoU: ")
    assert "Epoch [003/003], Step [0002/0002], Loss: " in log


def test_test_cli_scores_and_visualisations_match_jax(runs):
    assert runs["cm"].sum() == 2 * 64 * 64
    assert "mean loss: " in runs["test_log"] and "iou: " in runs["test_log"]
    assert runs["scores"]["iou"] == pytest.approx(
        runs["cm"][1, 1] / (runs["cm"].sum() - runs["cm"][0, 0] + np.finfo(np.float32).eps))
    # the same predictions, through the JAX package's test.py colorize and cv2.imwrite
    model = get_model("smow_net", device="cpu")
    restore_best_params(os.path.join(runs["out"], "best"), model)
    ds = CDDataset(runs["root"], "test")
    step = make_eval_step(model)
    jax_cli = _jax_test_cli()
    names = iter(ds.names)
    for batch in prefetch_to_device(iter(DataLoader(ds, 2, shuffle=False, num_workers=1)), "cpu"):
        _, _, pred = step(batch)
        pred = (pred > 0.5).numpy().astype(np.uint8)
        gt = (batch["mask"] > 0.5).numpy().astype(np.uint8)
        for b in range(pred.shape[0]):
            name = next(names)
            want_path = str(runs["tmp"] / f"cv2_{name}")
            cv2.imwrite(want_path, jax_cli.colorize(pred[b], gt[b]))
            got = np.asarray(Image.open(os.path.join(runs["vis"], name)))
            np.testing.assert_array_equal(got, np.asarray(Image.open(want_path)), err_msg=name)
            fp = (pred[b] == 1) & (gt[b] == 0)
            assert (got[fp] == (255, 0, 0)).all()          # FP red in the file
    assert next(names, None) is None


@pytest.mark.parametrize("name", ["fc_ef"])
def test_zoo_model_trains_and_tests_through_the_clis(runs, name):
    """A zoo model of the registry through both CLIs: one epoch at 64x64,
    then the test CLI on its `best`."""
    out = str(runs["tmp"] / f"out_{name}")
    first, log = _captured(cli_train.main, _train_opt(runs["root"], out, 1, "--model", name))
    assert first.state.optimizer.count == 2
    assert "Epoch [001/001], Step [0002/0002], Loss: " in log
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["epoch"] for r in records] == [1] and np.isfinite(records[0]["train_loss"])
    test_opt = cli_test.parse_option(["--model", name, "--data_dir", runs["root"],
                                      "--checkpoint", os.path.join(out, "best"), "--output_dir",
                                      str(runs["tmp"] / f"vis_{name}"), "--batchsize", "2",
                                      "--device", "cpu"])
    (scores, cm), test_log = _captured(cli_test.main, test_opt)
    assert cm.sum() == 2 * 64 * 64 and "mean loss: " in test_log
    assert 0.0 <= scores["iou"] <= 1.0
    assert len(os.listdir(str(runs["tmp"] / f"vis_{name}"))) == 2


def test_flags_and_devices_that_raise(runs):
    args = (runs["root"], str(runs["tmp"] / "never"), 1)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        cli_train.setup(_train_opt(*args, "--fsdp"))
    with pytest.raises(SystemExit, match="--remat supports change_mamba/rs_mamba, not smow_net"):
        cli_train.setup(_train_opt(*args, "--remat"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        cli_train.setup(_train_opt(*args, "--model", "seifnet"))
    with pytest.raises(SystemExit, match="--checkpoint / --torch_ckpt"):
        cli_test.main(cli_test.parse_option(["--device", "cpu"]))
    if not torch.cuda.is_available():
        # the default device is the card: without one both CLIs stop
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli_train.setup(cli_train.parse_option(["--data_dir", runs["root"]]))
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli_test.main(cli_test.parse_option(["--checkpoint", "best"]))


def test_remat_builds_the_mamba_models_with_checkpointing(runs, monkeypatch):
    """--remat as the JAX package's train.py takes it: use_checkpoint=True
    for change_mamba and rs_mamba, nothing without the flag (argument
    handling and the model's construction only: the fake get_model stops
    the setup there)."""
    import smow_net_tpu_torch.models as models

    class Built(Exception):
        pass

    def fake(name, device="cuda", **kwargs):
        raise Built(name, str(device), kwargs)

    monkeypatch.setattr(models, "get_model", fake)
    args = (runs["root"], str(runs["tmp"] / "never"), 1)
    for name in ("change_mamba", "rs_mamba"):
        for flags, kwargs in (((), {}), (("--remat",), {"use_checkpoint": True})):
            with pytest.raises(Built) as built:
                cli_train.setup(_train_opt(*args, "--model", name, *flags))
            assert built.value.args == (name, "cpu", kwargs)
    with pytest.raises(SystemExit, match="not cd_mamba"):
        cli_train.setup(_train_opt(*args, "--model", "cd_mamba", "--remat"))
