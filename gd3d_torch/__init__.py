"""gd3d_torch: the PyTorch + CUDA port of gd3d for one NVIDIA H100.

The package mirrors gd3d's module paths and public names
(`gd3d_torch/models/vit.py` is the counterpart of `gd3d/models/vit.py`, and
so on) and keeps gd3d's layouts at its public functions: NHWC images and
(B, N, H, D) attention inputs. It imports torch and numpy only, never JAX.

The training entry point (`gd3d_torch.cli.train`: the ME baseline, the
MASt3R and the VGGT distillation steps, with gd3d's step options, TensorBoard
event files and data-parallel training over torch.distributed ranks with an
optionally sharded teacher) and the evaluation entry point
(`gd3d_torch.cli.evaluate`: PF-PASCAL PCK, TAP-Vid DAVIS tracking and
OnePose-LowTexture pose with an EPnP RANSAC of its own, with the package's
own JPEG decoder and Lanczos resize) are ported, as are the FiT3D harness
(`gd3d_torch.eval.fit3d`) and the DUSt3R point tracker
(`gd3d_torch.eval.dust3r_tracker`), and so is multi-view reconstruction:
global alignment (`gd3d_torch.align`), TSDF refinement, COLMAP exports,
visual localization and the `align`, `localize` and `demo` entry points.
Every Pallas kernel of gd3d (K1 flash forward, K2 flash backward, K3
masked-softmax KL, K4 pairwise ranking, K5 RoPE2D) is a hand-written CUDA
kernel under `gd3d_torch/csrc/`, built at first use
(`gd3d_torch/kernels/build.py`). A kernel's wrapper launches it for CUDA
tensors and runs its plain PyTorch twin for CPU tensors.
"""
