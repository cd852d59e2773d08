"""BatchNorm's per-image batch moments (ops/bn_moments.py, the op
`odt::bn_moments` of ops/registry.py) and the BatchNorm built on them
(models/bn.py), on the CPU.

The moments of a batch are its images' rows, each from its own slice alone,
so a batch's rows equal the concatenation of its splits' bit for bit, and a
BatchNorm on 2 gloo ranks (one launch of 2 processes, whose worker lives in
this module, which imports nothing of JAX at its top) computes one process's
statistics and outputs bit for bit. The card's kernel is held to the same in
tests/test_torch_cuda.py and chip_smoke.py's `phase_kernel_vs_plain`."""

import numpy as np
import pytest
import torch
from torch.library import opcheck

from object_detection_torch2_tpu_torch.models.bn import BatchNorm, set_mesh
from object_detection_torch2_tpu_torch.ops import bn_moments_cuda, registry
from object_detection_torch2_tpu_torch.ops.bn_moments import bn_moments, bn_moments_plain
from object_detection_torch2_tpu_torch.parallel import mesh as mesh_lib
from object_detection_torch2_tpu_torch.parallel.mesh import local_rows

torch.set_num_threads(1)

# (N, C, H, W): a conv_1_1-like map, an odd channel count, and the extras'
# 3 x 3 and 1 x 1 maps, which PyTorch may call both NCHW and channels_last
SHAPES = ((5, 64, 21, 19), (5, 3, 7, 9), (5, 256, 3, 3), (5, 256, 1, 1))
SPLITS = ((1, 4), (2, 3))
GLOBAL, WORLD = 6, 2
BN_MASKS = {"none": None, "partial": [1, 0, 1, 1, 1, 0], "rank1_empty": [1, 1, 1, 0, 0, 0]}
CLUSTER_TIMEOUT = 300  # seconds


def _case(shape, dtype, channels_last, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).normal(1.5, 3.0, shape)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_plain_rows_do_not_depend_on_the_split(dtype):
    """A batch of 5's rows equal the concatenation of its splits' (1 + 4 and
    2 + 3) bit for bit, NCHW and channels_last, on every shape; the rows are
    float64 sums of x and of its square in the math dtype."""
    for shape in SHAPES:
        for channels_last in (False, True):
            x = _case(shape, dtype, channels_last)
            whole = bn_moments_plain(x)
            assert whole.shape == (shape[0], 2, shape[1]) and whole.dtype == torch.float64
            for split in SPLITS:
                parts = torch.cat([bn_moments_plain(p) for p in x.split(list(split))])
                assert torch.equal(_bits(parts), _bits(whole)), (shape, channels_last, split)
            xm = x.double() if dtype == torch.float64 else x.float()
            np.testing.assert_allclose(whole[:, 0].numpy(), xm.double().sum((2, 3)).numpy(), rtol=1e-12, atol=1e-9)
            np.testing.assert_allclose(whole[:, 1].numpy(), xm.square().double().sum((2, 3)).numpy(), rtol=1e-12)


def test_op_on_the_cpu_is_the_plain_version():
    """`bn_moments` on a CPU tensor is the plain version through the custom
    op, launches nothing, and passes torch.library.opcheck (schema, fake
    implementation, autograd registration); another device raises."""
    x = _case((3, 8, 5, 4), torch.float32, True)
    before = bn_moments_cuda.kernel_launches
    assert torch.equal(bn_moments(x), bn_moments_plain(x))
    assert torch.equal(torch.ops.odt.bn_moments(x), bn_moments_plain(x))
    assert bn_moments_cuda.kernel_launches == before
    opcheck(registry.bn_moments, (x.requires_grad_(True),))
    with pytest.raises(ValueError, match="device"):
        bn_moments(x.detach().to("meta"))


def test_op_gradient_passes_gradcheck():
    """The registered gradient, g[:, 0] + 2 x g[:, 1], against finite
    differences in float64, both layouts."""
    for channels_last in (False, True):
        x = _case((2, 3, 4, 3), torch.float64, channels_last).requires_grad_(True)
        assert torch.autograd.gradcheck(bn_moments, (x,))


def test_fake_implementation_traces_in_export():
    """torch.export traces a batch-statistics BatchNorm through the fake
    implementation: the graph holds one odt.bn_moments call, and the
    program computes what the module does."""
    bn = BatchNorm(8).eval()

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = bn

        def forward(self, x, m):
            return self.bn(x, True, m)

    x, m = _case((4, 8, 5, 5), torch.float32, True), torch.tensor([1.0, 1.0, 0.0, 1.0])
    program = torch.export.export(Net(), (x, m))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("odt.bn_moments.default") == 1, targets
    with torch.no_grad():
        assert torch.equal(program.module()(x, m), bn(x, True, m))


def test_batchnorm_matches_jax():
    """BatchNorm with batch statistics (no mask and a pad-row mask) against
    the JAX package's BatchNormTPU on the same seeded numpy inputs, in both
    layouts: the outputs and the running statistics at atol 1e-6. The
    inputs are tests/test_torch_models.py's `_bn_case(1)`: the reference's
    own x * inv + (bias - mean * inv) rounding (models/bn.py) exceeds 1e-6
    on other draws of the same distribution, however the moments are
    summed."""
    import jax
    import jax.numpy as jnp

    from object_detection_torch2_tpu.models.bn import BatchNormTPU

    rng = np.random.default_rng(1)
    x = rng.normal(1.5, 2.0, (6, 5, 7, 8)).astype(np.float32)
    x[4:] = 7.0  # the rows the mask drops
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.normal(0, 0.5, 8).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 1, 8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}}
    ref = jax.jit(BatchNormTPU(use_running_average=False).apply, static_argnames="mutable")
    for mask in (None, np.array([1, 1, 1, 1, 0, 0], np.float32)):
        y_ref, upd = ref(variables, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                         mutable=("batch_stats",))
        for channels_last in (False, True):
            bn = BatchNorm(8).train()
            bn.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                                "bias": torch.from_numpy(variables["params"]["bias"]),
                                "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
                                "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
                                "num_batches_tracked": torch.tensor(0)})
            xt = torch.from_numpy(x).permute(0, 3, 1, 2)
            xt = xt.contiguous(memory_format=torch.channels_last) if channels_last else xt.contiguous()
            with torch.no_grad():
                y = bn(xt, True, None if mask is None else torch.from_numpy(mask))
            np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), atol=1e-6)
            for key, want in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(getattr(bn, key).numpy(), np.asarray(upd["batch_stats"][want]), atol=1e-6)


# ------------------------------------------------ one process against 2 ranks


def _bn_run(mesh, mask, dtype, channels_last) -> dict:
    """One training-mode BatchNorm forward and backward of sum(out * r) on
    the mesh's rows (all rows without one), in `dtype`."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(1.0, 3.0, (GLOBAL, 16, 6, 5))).to(dtype)
    r = torch.from_numpy(rng.normal(0.0, 1.0, (GLOBAL, 16, 6, 5))).to(dtype)
    weight, bias = rng.uniform(0.5, 1.5, 16), rng.normal(0.0, 1.0, 16)
    x, r = local_rows(x, mesh), local_rows(r, mesh)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    m = None if mask is None else local_rows(torch.tensor(mask, dtype=torch.float32), mesh)
    bn = set_mesh(BatchNorm(16).to(torch.float64 if dtype == torch.float64 else torch.float32), mesh)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x.requires_grad_(True)
    out = bn(x, True, m)
    (out * r).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _bn_cases():
    return [(case, dtype, cl) for case in BN_MASKS for dtype in (torch.float32, torch.float64) for cl in (False, True)]


def _bn_rank(mesh) -> list:
    return [_bn_run(mesh, BN_MASKS[case], dtype, cl) for case, dtype, cl in _bn_cases()]


def test_batchnorm_two_ranks_equal_one_process():
    """BatchNorm with batch statistics on 2 gloo ranks (3 rows each; with no
    mask, a mask, and rank 1's rows all masked) against one process over the
    whole batch, NCHW and channels_last: the float32 and float64 outputs and
    running statistics bit for bit, the ranks' running statistics identical;
    in float64 the input gradients of each rank's rows and the weight and
    bias gradients (summed over the ranks: the loss is the sum of theirs)
    within 1e-12."""
    ranks = mesh_lib.launch(_bn_rank, WORLD, device_type="cpu", timeout=CLUSTER_TIMEOUT)
    for i, (case, dtype, cl) in enumerate(_bn_cases()):
        one, a, b = _bn_run(None, BN_MASKS[case], dtype, cl), ranks[0][i], ranks[1][i]
        what = (case, dtype, cl)
        assert torch.equal(torch.cat([a["out"], b["out"]]), one["out"]), what
        for key in ("running_mean", "running_var"):
            assert torch.equal(a[key], one[key]) and torch.equal(b[key], one[key]), (what, key)
        if dtype == torch.float64:
            np.testing.assert_allclose(torch.cat([a["x_grad"], b["x_grad"]]).numpy(), one["x_grad"].numpy(),
                                       rtol=1e-12, atol=1e-12, err_msg=str(what))
            for key in ("weight_grad", "bias_grad"):
                np.testing.assert_allclose((a[key] + b[key]).numpy(), one[key].numpy(), rtol=1e-12, atol=1e-12,
                                           err_msg=f"{what} {key}")
