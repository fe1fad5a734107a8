"""The intra-depth loss of a bf16 student: the port against both of gd3d's
paths, on the CPU.

The port's Student.intra_depth_loss always takes gd3d's fused form (u =
feat . W + b in fp32, then the whole pair chain in fp32, K4's twin here).
gd3d's default path (no GD3D_PAIRWISE_PALLAS) runs the depth head's Dense
layers in the compute dtype, bf16 here; its fused path runs the Pallas
kernel, in interpret mode here. Same numpy-seeded keypoint features, depths
and masks, and one set of weights, gd3d's TINY student (as
tests/test_bf16_student.py) converted to the port.

Bounds: the port against gd3d's fused path to fp32 round-off (rtol 3e-5,
as tests/test_torch_pairwise_rank.py holds the fp32 student); the port
against gd3d's default path within BF16_GAP of the loss, and no further
from it than gd3d's fused path is. The measured gaps are in PERF.md.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.kernels.pairwise_rank import pairwise_ranking_sums_fused
from gd3d.models.student import Student as JStudent
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.student import Student

THR = 0.05
# gd3d's TINY student (tests/test_bf16_student.py), at a depth-head width
# K4 takes on the card
TINY = dict(embed_dim=64, depth=4, num_heads=2, patch_size=8, pretrain_img_size=32,
            lora_start_block=2, use_adapters=True, adapter_bottleneck=8, target_res=64,
            depth_head_hidden=32)
# bf16 keeps 8 mantissa bits: the default path rounds the head's operands
# and Dense outputs to bf16, 2^-9 relative each at most; the loss, a mean of
# smooth functions of them over ~10^3 pairs, moves by less than that
# relative amount (measured: 6e-5 of it)
BF16_GAP = 2.0 ** -9


def _gd3d_fused(params, feats, depths, valid):
    """gd3d's fused branch (gd3d/models/student.py:430-454), with the Pallas
    kernel in interpret mode."""
    dh = params["depth_diff_head"]
    u = feats.astype(jnp.float32) @ dh["fusion_in"]["kernel"] + dh["fusion_in"]["bias"]
    sums, cnts = pairwise_ranking_sums_fused(
        u, dh["fusion_in"]["bias"], dh["fusion_ln"]["scale"], dh["fusion_ln"]["bias"],
        dh["fusion_out"]["kernel"][:, 0], dh["fusion_out"]["bias"], depths, valid, THR,
        interpret=True)

    def view_mean(s, c):
        tot, cnt = jnp.sum(s), jnp.sum(c)
        return jnp.where(cnt > 0, tot / jnp.maximum(cnt, 1.0), 0.0)

    B = feats.shape[0] // 2
    return (view_mean(sums[:B], cnts[:B]) + view_mean(sums[B:], cnts[B:])) / 2.0


@pytest.mark.parametrize("n,seed", [(64, 0), (96, 1)])
def test_bf16_intra_depth_loss_against_both_gd3d_paths(n, seed):
    jcfg = JStudentConfig(**TINY, compute_dtype="bfloat16")
    jst = JStudent(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jst.init(jax.random.key(seed), img_size=32))
    st = Student(StudentConfig(**TINY, compute_dtype="bfloat16"))
    st.load_state_dict(student_state_dict(params, st.cfg))
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, n, 64).astype(np.float32)
    depths = (rng.rand(2, n) * 3).astype(np.float32)
    valid = rng.rand(2, n) > 0.3
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jin = (jnp.asarray(feats), jnp.asarray(depths), jnp.asarray(valid))
    default = float(jst.intra_depth_loss(jparams, *jin, THR))
    fused = float(_gd3d_fused(jparams, *jin))
    with torch.no_grad():
        port = float(st.intra_depth_loss(torch.from_numpy(feats), torch.from_numpy(depths),
                                         torch.from_numpy(valid), THR))
    gap_port, gap_gd3d = abs(port - default), abs(fused - default)
    print(f"n={n}: port {port:.7f}, gd3d default (bf16 Dense) {default:.7f}, gd3d fused "
          f"{fused:.7f}; |port - default| {gap_port:.3e}, |fused - default| {gap_gd3d:.3e}")
    np.testing.assert_allclose(port, fused, rtol=3e-5, atol=1e-6)
    assert gap_port <= BF16_GAP * abs(default)
    # the port is no further from gd3d's default path than gd3d's own fused path
    assert gap_port <= gap_gd3d + 3e-5 * abs(fused) + 1e-6
