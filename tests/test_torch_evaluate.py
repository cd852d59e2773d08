"""The port's evaluation slice as a whole on the CPU: its `build_eval_pipeline`
and its `cli.evaluate.main` against the JAX package's evaluation pipeline, on
the JAX package's own init weights (a weights.msgpack written by the JAX
package for the CLI). Its port-only tests (K stacked batches and float16
scores, the int8 flags, the CLI's flags against its plain run) are marked
`slow`: chip_smoke.py's `phase_moved_serving` holds each at its pins on the
card."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.cli import common as jax_common
from object_detection_torch2_tpu.cli.evaluate import build_eval_pipeline as jax_eval_pipeline
from object_detection_torch2_tpu.data.voc import PascalVOCDataset as JaxVOC
from object_detection_torch2_tpu.data.voc import collate as jax_collate
from object_detection_torch2_tpu.metrics.ap import APAccumulator as JaxAPAccumulator
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.train import checkpoint as jax_ckpt
from object_detection_torch2_tpu.utils.testing import synth_targets
from object_detection_torch2_tpu_torch.cli import common, evaluate
from object_detection_torch2_tpu_torch.data.records import pack_voc
from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
from object_detection_torch2_tpu_torch.models.ssd import SSD

torch.set_num_threads(1)

IMSIZE = 264  # the smallest valid SSD pyramid
BATCH = 3
G_PAD = 64  # the CLI's --max_gt default: the seeded case shares the fixture's compiled shapes
FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
CLI_ARGS = ["--imsize", str(IMSIZE), "--batch_size", str(BATCH), "--bn_mode", "running", "--dtype", "float32",
            "--device", "cpu", "--strict_ap", "--num_workers", "0"]


@pytest.mark.slow
def test_eval_pipeline_k_stacked_and_half_scores():
    """build_eval_pipeline on K stacked batches equals K calls; d2h_half
    casts only the scores leaf to float16."""
    model = SSD(num_classes=21, seed=1)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    gts = np.stack([synth_targets(rng, BATCH, [2, 1, 3], G_PAD) for _ in range(2)])
    run = evaluate.build_eval_pipeline(model, True, IMSIZE, 20, device="cpu")
    half = evaluate.build_eval_pipeline(model, True, IMSIZE, 20, device="cpu", d2h_half=True)
    stacked, n_valid = run(images, gts, [3, 2])
    halved, _ = half(images, gts, [3, 2])
    for k, real in enumerate((3, 2)):
        single, nv = run(images[k], gts[k], real)
        assert torch.equal(n_valid[k], nv)
        for key in single:
            assert torch.equal(stacked[key][k], single[key]), key
            if key == "scores":
                assert halved[key].dtype == torch.float16 and torch.equal(halved[key][k], single[key].half())
            else:
                assert torch.equal(halved[key][k], single[key]), key


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_padding_helpers_match_jax(n):
    """pad_rows, pad_batch and batched equal the JAX package's (pad_batch
    needs a row to repeat)."""
    rows = np.arange(n * 2 * 3, dtype=np.uint8).reshape(n, 2, 3)
    got, want = common.pad_rows(rows, BATCH), jax_common.pad_rows(rows, BATCH)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if n:
        (got, real), (want, want_real) = common.pad_batch(rows, BATCH), jax_common.pad_batch(rows, BATCH)
        assert real == want_real == n
        np.testing.assert_array_equal(got, want)
    assert list(common.batched(3 * n + 1, 2)) == list(jax_common.batched(3 * n + 1, 2))


@pytest.mark.parametrize("flags,item", [(["--distributed"], "G"), (["--num_devices", "2"], "G")])
def test_cli_unported_flags_raise(tmp_path, flags, item, capsys):
    """The flags of ROADMAP Queue 1 item G (data parallelism), ported:
    --distributed without torchrun's environment raises; --num_devices 2 at
    batch 3 serves on the largest count that divides the batch, one process,
    with the JAX package's note (tests/test_torch_parallel_cli.py runs 2)."""
    argv = CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)] + flags
    if flags == ["--distributed"]:
        with pytest.raises(RuntimeError, match="torchrun"):
            evaluate.main(argv)
        return
    aps, _, _, _ = evaluate.main(argv)
    assert "note: serving on 1 device(s) — batch_size 3 does not divide over 2" in capsys.readouterr().out
    assert len(aps) == 20 and item == "G"


@pytest.mark.slow
@pytest.mark.parametrize("flag,calls", [("--trunk_int8", 11), ("--full_int8", 27)])
def test_cli_int8_flags_run(tmp_path, monkeypatch, flag, calls):
    """--trunk_int8 (scales from the quant.json the training CLI writes) and
    --full_int8 (calibrated here, written to quant_full.json) evaluate the
    fixture on the model's int8 path: that many int8 convolutions a batch,
    the report written, each AP of a class with ground truth in [0, 1]."""
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models import ssd as ssd_mod

    if flag == "--trunk_int8":
        (tmp_path / "detection").mkdir(parents=True)
        quant.save_quant(tmp_path / "detection" / "quant.json",
                         {f"amax_{layer}": 4.0 for layer in quant.QUANT_LAYERS})
    seen = []
    real = ssd_mod.int8_conv
    monkeypatch.setattr(ssd_mod, "int8_conv", lambda *a: seen.append(1) or real(*a))
    aps, mean_ap, _, _ = evaluate.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path), flag])
    assert len(seen) == 2 * calls  # the fixture's 4 images: 2 batches
    scored = aps[~np.isnan(aps)]
    assert len(scored) and ((scored >= 0) & (scored <= 1)).all() and 0 <= mean_ap <= 1
    assert list((tmp_path / "detection").glob("*.md"))
    if flag == "--full_int8":
        qd = quant.load_quant(tmp_path / "detection" / "quant_full.json")
        assert quant.missing_layers(qd, quant.FULL_QUANT_LAYERS) == []


def test_cli_without_device_needs_a_card(tmp_path):
    """No --device: the CLI runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is available")
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(args + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)])


# The tests below take the JAX package's seeded init, a jitted program that
# tests/test_torch_parallel.py, test_torch_checkpoint.py and test_torch_train_cli.py
# compile too: placed after the port-only tests, they usually find it in the
# persistent compile cache.


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's init variables and its evaluation pipeline, compiled
    once for (3, 264, 264, 3) images and (3, 64, 25) GTs, running statistics."""
    jmodel = JaxSSD(num_classes=21)
    # one program, compiled at XLA's backend optimization level 1: a third of
    # the default level's compile CPU, the same variables bit for bit
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMSIZE, IMSIZE, 3)), train=False))
    key = jax.random.PRNGKey(0)
    variables = init.lower(key).compile(compiler_options={"xla_backend_optimization_level": 1})(key)
    variables = jax.tree.map(np.asarray, variables)
    run = jax_eval_pipeline(jmodel, use_batch_stats=False, imsize=IMSIZE, num_classes=20)
    jvars = jax.tree.map(jnp.asarray, variables)

    def jax_run(images_u8, gts, n_real):
        matches, n_valid = run(jvars, jnp.asarray(images_u8), jnp.asarray(gts), n_real)
        return {k: np.asarray(v) for k, v in matches.items()}, np.asarray(n_valid)

    return variables, jax_run


def _assert_matches_near(got, want, rtol=1e-5, atol=1e-6):
    """counts equal; per image and class, each of the port's ranked
    (correct, score) entries pairs with one of the JAX package's within 3
    ranks, with the same flag and a score within tolerance — two near-equal
    scores may swap ranks, as tests/test_torch_infer.py::_match_near_ties
    allows; the scores in that pairing within rtol / atol."""
    np.testing.assert_array_equal(got["counts"], want["counts"])
    n, c, k = got["correct"].shape
    for i in range(n):
        for cls in range(c):
            gc, gs = got["correct"][i, cls], got["scores"][i, cls]
            wc, ws = want["correct"][i, cls], want["scores"][i, cls]
            free = set(range(k))
            for r in range(k):
                near = sorted((j for j in free if abs(j - r) <= 3), key=lambda j: abs(j - r))
                match = [j for j in near if gc[r] == wc[j] and np.isclose(gs[r], ws[j], rtol=rtol, atol=atol)]
                assert match, f"image {i} class {cls} rank {r}: no counterpart in the JAX package's matches"
                free.discard(match[0])


def test_eval_pipeline_matches_jax(jax_side):
    """Seeded images and synth_targets GTs at batch 3, the last row a pad row
    (n_real 2): n_valid and counts equal, correct and scores equal up to
    near-tie rank swaps."""
    variables, jax_run = jax_side
    rng = np.random.default_rng(17)
    images = rng.integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    gts = synth_targets(rng, BATCH, rng.integers(1, 9, BATCH), g_pad=G_PAD)
    model = SSD(num_classes=21)
    model.load_state_dict(ssd_state_dict_from_jax_variables(variables))
    run = evaluate.build_eval_pipeline(model, use_batch_stats=False, imsize=IMSIZE, num_classes=20, device="cpu")
    for n_real in (BATCH, 2):
        matches, n_valid = run(images, gts, n_real)
        got = {k: v.numpy() for k, v in matches.items()}
        want, want_valid = jax_run(images, gts, n_real)
        np.testing.assert_array_equal(n_valid.numpy(), want_valid)
        assert got["correct"].shape == (BATCH, 20, 200) and got["counts"].dtype == np.int32
        _assert_matches_near(got, want)
        assert (got["scores"][n_real:] == 0).all() and (got["counts"][n_real:] == 0).all()


def _jax_fixture_aps(jax_run):
    """The fixture's test list through the JAX pipeline in batches of three
    and one (padded to three), as the CLI batches it."""
    ds = JaxVOC("detection", [FIXTURE], "test.txt", IMSIZE)
    acc = JaxAPAccumulator(20)
    for start in range(0, len(ds), BATCH):
        images, gts = jax_collate([ds[i] for i in range(start, min(start + BATCH, len(ds)))], max_gt=G_PAD)
        matches, _ = jax_run(jax_common.pad_rows(images, BATCH), jax_common.pad_rows(gts, BATCH), images.shape[0])
        acc.update(matches)
    return acc.result(strict=False), acc.result(strict=True)


@pytest.fixture(scope="module")
def cli_run(jax_side, tmp_path_factory):
    variables, jax_run = jax_side
    result_dir = tmp_path_factory.mktemp("result")
    jax_ckpt.save_weights(result_dir / "detection" / "weights.msgpack", variables)
    out = evaluate.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(result_dir)])
    return result_dir, out, _jax_fixture_aps(jax_run)


def _assert_aps_close(got, want):
    assert got.shape == want.shape == (20,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got, nan=-1), np.nan_to_num(want, nan=-1), atol=1e-6)


def test_cli_main_matches_jax_map(cli_run):
    """The CLI on the fixture tree: per-class parity and strict AP within 1e-6
    of the JAX pipeline's, nan in the same places; the report names every class."""
    result_dir, (aps, mean_ap, strict_mean, strict_aps), ((want_aps, want_mean), (want_strict, want_smean)) = cli_run
    _assert_aps_close(aps, want_aps)
    _assert_aps_close(strict_aps, want_strict)
    np.testing.assert_allclose([mean_ap, strict_mean], [want_mean, want_smean], atol=1e-6)
    assert np.isfinite(aps).sum() > 0
    reports = list((result_dir / "detection").glob("report_*.md"))
    assert len(reports) == 1
    text = reports[0].read_text()
    from object_detection_torch2_tpu_torch.data.labelmap import LabelMap

    for name in LabelMap("PascalVOC").labels:
        assert f"|{name}|" in text


def test_cli_main_records_gives_same_aps(cli_run, tmp_path):
    """The same evaluation through --records_dir (packed by the port's pack_voc)."""
    result_dir, (aps, mean_ap, strict_mean, strict_aps), _ = cli_run
    pack_voc([FIXTURE], "test.txt", tmp_path / "rec", imsize=IMSIZE, max_gt=G_PAD, log_every=0)
    got = evaluate.main(CLI_ARGS + ["--records_dir", str(tmp_path / "rec"), "--result_dir", str(result_dir)])
    np.testing.assert_array_equal(got[0], aps)
    np.testing.assert_array_equal(got[3], strict_aps)
    np.testing.assert_array_equal(got[1:3], (mean_ap, strict_mean))


@pytest.fixture(scope="module")
def plain_cli_run(tmp_path_factory):
    """The CLI on the fixture tree with the seeded SSD (no weights file): its
    APs, the port's alone."""
    return evaluate.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir",
                                     str(tmp_path_factory.mktemp("plain"))])


@pytest.mark.slow
@pytest.mark.parametrize("flags", [["--batches_per_dispatch", "2"], ["--d2h_half"],
                                   ["--batches_per_dispatch", "3", "--d2h_half"]])
def test_cli_flags_match_the_plain_run(plain_cli_run, tmp_path, flags):
    """K batches a call (2: both batches in one call; 3: more than there
    are, so each runs alone) gives the plain run's APs exactly; with float16
    match scores the parity APs (recall) are exact and the strict APs within
    1e-6 (no two of these scores round to a tie). The seeded SSD's, port
    against port: marked slow, chip_smoke.py's phase_moved_serving holds it
    on the card."""
    aps, mean_ap, strict_mean, strict_aps = plain_cli_run
    got = evaluate.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)] + flags)
    np.testing.assert_array_equal(got[0], aps)
    assert got[1] == mean_ap
    if "--d2h_half" in flags:
        _assert_aps_close(got[3], strict_aps)
    else:
        np.testing.assert_array_equal(got[3], strict_aps)
        assert got[2] == strict_mean
