"""depth_estimation_tpu_torch — the PyTorch/CUDA port of ``depth_estimation_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same path there, holds the same layouts at its public
functions (channels-last ``(B, H, W, C)`` frames and features, ``(B, H, W)``
flow, mask and depth), and is tested against it on the same inputs
(``tests/test_torch_*.py``). This package imports torch and numpy, never jax.

The package's TPU kernels are hand-written CUDA C++ for Hopper (``csrc/``),
built with nvcc at first use (``ops/_kernels.py``):

  ops/matching.match_flow_fused               <- csrc/match_fused.cu (B1)
  ops/matching.match_flow_fast                <- csrc/match_fast.cu (B2)
  ops/warp.banded_bilinear_warp               <- csrc/warp_banded.cu (B3)
  flow/sor_kernel.sor_redblack                <- csrc/sor_redblack.cu (B4)
  ops/matching_experimental.match_flow_throughput
                                              <- csrc/match_throughput.cu (B5)
  benchmarks/device_peaks.vpu_loop            <- csrc/vpu_peak.cu (P1)
  benchmarks/device_peaks.logistic_loop       <- csrc/vpu_peak.cu (P2)

Each has a plain PyTorch twin in the same module, used for CPU tensors.
B1 and B3 are also the operators ``depth_estimation_tpu_torch::
match_flow_fused`` and ``::banded_bilinear_warp`` (``torch.library``), so
that ``torch.export`` keeps them in the serving artifacts (``serving.py``).

Layer map (every module of the JAX package has its counterpart here, or
a recorded decision not to port it, ROADMAP A.16):
  geometry / codecs            static config + displacement index codecs
  geometry3d/                  calibration, undistortion + rotation warps,
                               Shi-Tomasi + windowed and full-image LK +
                               essential RANSAC, the 4-DoF motion model,
                               polar warps and radial flow -> depth
  models/                      conv trunk, single-scale flow model with its
                               training heads, the multiscale, radial,
                               version2 and legacy families, checkpoints
                               (read and write) and weight bridges
  data/                        image files and resizes, the live camera
                               (V4L2), flow ground truth, the trainers'
                               datasets
  training/                    SGD with torch-optim semantics, criteria,
                               patch and fovea samplers, the single-scale
                               and multiscale trainers, scores and curves
  flow/                        Ce Liu's variational solver
  ops/                         matchers, banded warp, confidence masks,
                               post-processing filters, normalizations
  api / api_batched            the per-frame and the batched online programs
  parallel/                    the mesh layer: the batched programs, the
                               trainers and the offline builds split over
                               the cards of a host (data parallel, one
                               process and a host thread a card), and one
                               frame split by rows with halos
  serving                      torch.export artifacts of every family and of
                               the batched online program
  cli/                         tools (rectify, download, stream, video,
                               time-matching, export), the radial tester,
                               and the training CLIs (opticalflow,
                               train_radial, train_v2, depth_estimation)
  robotics/                    the native drone runtime (its own copy of
                               the C++ in robotics/native/, built with g++
                               at first use into _build/: simulator, depth
                               maps, FIFO link), the real-drone adapter
                               (FifoDroneAPI: the estimator and the depth
                               rule on the card), the avoidance controller
                               and keyboard teleop
  benchmarks/                  the peak meter (P1, P2) and the
                               speed-of-light report, with the bound
                               formulas of PERF.md's kernel table
  utils/                       device selection, timers, profiler spans
                               and traces, flow colourings, PNG / video
                               files, the live viewer
"""

__version__ = "0.1.0"

from .geometry import Geometry, Learning  # noqa: F401
