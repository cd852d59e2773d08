"""The three CLIs on several processes on the CPU: `--num_devices 2 --device
cpu` starts 2 gloo processes (cli.common.run_data_parallel), each of which
runs its slice of every batch; held against the same CLI on one process.

The serving runs read 5 records at batch 4 (the fixture's 4 photographs and
one of them mirrored): the second batch's one image is rank 0's, and rank 1's
slice of it is empty, so rank 1 runs pad rows only and still joins every
collective. Their ground truth is planted on the seeded model's own top-3
detections of each image (as chip_smoke.py's evaluation phase does), so the
parity mAP is 1.0 and every box is claimed."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from object_detection_torch2_tpu_torch.cli import evaluate, inference, train
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.infer import Predictor
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
IMSIZE = 264
BATCH = 4
G_PAD = 8
SERVE = ["--imsize", str(IMSIZE), "--batch_size", str(BATCH), "--dtype", "float32", "--num_workers", "0",
         "--device", "cpu"]
TRAIN = ["--data_dirs", str(FIXTURE), "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype", "float32",
         "--num_workers", "0", "--device", "cpu", "--epochs", "1"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """5 records: the fixture's photographs and the first one mirrored, with
    ground truth on the seeded SSD's top-3 detections (batch statistics, as
    the CLI serves), written with numpy in the layout of data/records.py."""
    ds = PascalVOCDataset("detection", [FIXTURE], "test.txt", IMSIZE)
    images = np.stack([ds[i][0] for i in range(4)] + [ds[0][0][:, ::-1]])
    dets = Predictor(SSD(num_classes=21, seed=0), imsize=IMSIZE, batch_size=BATCH, device="cpu").predict(images)
    gts = np.zeros((len(images), G_PAD, 25), np.float32)
    for i, d in enumerate(dets):
        k = min(3, len(d.scores))
        gts[i, :k, :4] = d.boxes[:k]
        gts[i, np.arange(k), 4 + d.class_ids[:k] + 1] = 1.0
    out = tmp_path_factory.mktemp("records")
    np.save(out / "images.npy", images)
    np.save(out / "gts.npy", gts)
    (out / "meta.json").write_text(json.dumps({"imsize": IMSIZE, "max_gt": G_PAD, "count": len(images),
                                               "purpose": "detection", "sources": [], "list_file": ""}))
    return out


def test_evaluate_two_processes_report_the_single_process_map(records, tmp_path, capfd):
    """`cli.evaluate --num_devices 2` (rank 1's final slice empty) reports
    the single-process run's per-class parity and strict APs exactly; rank 0
    alone prints and writes the report."""
    argv = SERVE + ["--records_dir", str(records), "--strict_ap"]
    one = evaluate.main(argv + ["--result_dir", str(tmp_path / "one")])
    capfd.readouterr()
    two = evaluate.main(argv + ["--result_dir", str(tmp_path / "two"), "--num_devices", "2"])
    out = capfd.readouterr().out
    assert one[1] == 1.0  # planted ground truth: every box claimed
    np.testing.assert_array_equal(two[0], one[0])
    np.testing.assert_array_equal(two[3], one[3])
    assert (two[1], two[2]) == (one[1], one[2])
    assert out.count("Finished Evaluate") == 1
    assert len(list((tmp_path / "two" / "detection").glob("report_*.md"))) == 1


@pytest.mark.parametrize("bn_mode", ["batch", "running"])
def test_inference_two_processes_write_the_single_process_pngs(records, tmp_path, bn_mode):
    """`cli.inference --num_devices 2`: each rank renders its own rows, and
    together they write the single-process run's set of PNGs, numbered by
    global index. With running statistics no reduction crosses the ranks and
    every PNG is the single-process one pixel for pixel; with batch
    statistics the synced moments' reduction order moves a box edge by a
    pixel now and then (a few dozen of 5 x 209,088 pixels here), so fewer
    than 0.1% of an image's pixels may differ."""
    argv = SERVE + ["--records_dir", str(records), "--bn_mode", bn_mode]
    inference.main(argv + ["--result_dir", str(tmp_path / "one")])
    inference.main(argv + ["--result_dir", str(tmp_path / "two"), "--num_devices", "2"])
    names = sorted(p.name for p in (tmp_path / "one" / "detection").glob("*.png"))
    assert names == [f"{i:06}.png" for i in range(1, 6)]
    assert sorted(p.name for p in (tmp_path / "two" / "detection").glob("*.png")) == names
    for name in names:
        got = np.asarray(Image.open(tmp_path / "two" / "detection" / name))
        want = np.asarray(Image.open(tmp_path / "one" / "detection" / name))
        if bn_mode == "running":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got.shape == want.shape and (got != want).any(axis=-1).mean() < 1e-3, name


def test_train_two_processes_match_one(tmp_path, capfd):
    """`cli.train --num_devices 2` on the fixture (2 steps at global batch 2,
    one image a rank; validation on): the first step's loss within rtol 1e-5
    of the single-process run's, the second's within 1e-4 and the validation
    loss within 1e-2, after the Adam steps; the heads' updates within 5% in L2 and every
    trained tensor within the trajectory's fingerprint budget (Adam turns the
    ranks' reduction-order ulps into +-lr steps, as the port's single-device
    test against the JAX package allows, tests/test_torch_train_cli.py); the
    frozen trunk bit-equal. Rank 0 alone writes: one event file, one
    phase_times.json, one weights file and params.json, and one set of
    epoch lines."""
    from object_detection_torch2_tpu.utils.testing import fingerprint_tree

    def run(name, *flags):
        return train.main(TRAIN + ["--result_dir", str(tmp_path / name), "--log_dir", str(tmp_path / name / "logs"),
                                   *flags])

    one = run("one")
    capfd.readouterr()
    two = run("two", "--num_devices", "2")
    out = capfd.readouterr().out
    assert "state" not in two
    got_losses, want_losses = two["losses"][0].numpy(), one["losses"][0].cpu().numpy()
    np.testing.assert_allclose(got_losses[0], want_losses[0], rtol=1e-5)
    # after one Adam step, the trajectory's step-0 pin (tests/test_torch_train_cli.py)
    np.testing.assert_allclose(got_losses[1:], want_losses[1:], rtol=1e-4)
    # the validation pass follows both Adam steps: ~sign(g) * lr steps of the
    # near-zero gradients part the two models (measured 0.26%)
    np.testing.assert_allclose(two["val_losses"], one["val_losses"], rtol=1e-2)
    w0 = {k: v.numpy() for k, v in SSD(num_classes=21, seed=0).state_dict().items()}
    got = ckpt.load_weights(tmp_path / "two" / "detection" / "weights.msgpack")["params"]
    want = ckpt.load_weights(tmp_path / "one" / "detection" / "weights.msgpack")["params"]
    trained = {layer: want[layer] for layer in want if SSD.is_trainable(layer)}
    keys, want_fp = fingerprint_tree(trained)
    _, got_fp = fingerprint_tree({layer: got[layer] for layer in trained})
    assert (np.abs(got_fp - want_fp).max(axis=1) <= 5e-3 * want_fp[:, 0] + 1e-2).all()
    for layer in (k for k in want if k.startswith("det_")):
        w_init = w0[f"detectors.{layer}.weight"].transpose(2, 3, 1, 0)
        a, b = got[layer]["kernel"] - w_init, want[layer]["kernel"] - w_init
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), layer
    for layer in (k for k in want if not SSD.is_trainable(k)):
        for leaf in want[layer]:
            np.testing.assert_array_equal(got[layer][leaf], want[layer][leaf])
    assert len(list((tmp_path / "two" / "logs").glob("events.out.tfevents.*"))) == 1
    assert (tmp_path / "two" / "logs" / "phase_times.json").exists()
    assert (tmp_path / "two" / "detection" / "params.json").exists()
    assert out.count("[Epoch 1/1]") == 1 and out.count("Finished Training") == 1


@pytest.mark.parametrize("cli", [train, evaluate, inference])
def test_distributed_needs_torchrun_environment(cli, tmp_path, monkeypatch):
    """--distributed without torchrun's environment raises in every CLI: no
    quiet world of one."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = (TRAIN if cli is train else SERVE + ["--data_dirs", str(FIXTURE)])
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(argv + ["--result_dir", str(tmp_path), "--distributed"])


def test_distributed_world_of_one_equals_one_process(records, tmp_path, monkeypatch):
    """`cli.evaluate --distributed` under torchrun's environment for a world
    of one (gloo on the CPU) computes the single-process run's APs, and
    leaves the process group."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(var, value)
    argv = SERVE + ["--records_dir", str(records), "--strict_ap", "--bn_mode", "running"]
    one = evaluate.main(argv + ["--result_dir", str(tmp_path / "one")])
    dist_run = evaluate.main(argv + ["--result_dir", str(tmp_path / "dist"), "--distributed"])
    assert not dist.is_initialized()
    np.testing.assert_array_equal(dist_run[0], one[0])
    assert (dist_run[1], dist_run[2]) == (one[1], one[2])
    with pytest.raises(ValueError, match="--num_devices 2 unsupported with --distributed"):
        evaluate.main(argv + ["--result_dir", str(tmp_path / "x"), "--distributed", "--num_devices", "2"])
    assert not dist.is_initialized()
