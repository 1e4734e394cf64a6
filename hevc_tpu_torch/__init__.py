"""hevc_tpu_torch — the HEVC (H.265) encoder on PyTorch and CUDA.

A port of the JAX/TPU package ``hevc_tpu`` to an NVIDIA Hopper GPU (H100).
The host side (parameter sets, GOP scheduling, the native C++ CU engine,
CABAC, loop filters, NAL assembly) is this package's own copy of the
reference's host code; the device side runs as PyTorch tensor code and
hand-written CUDA kernels (``csrc/``, built with nvcc at first use and
bound with ctypes, see ``runtime.py``):

* ``ops/me_ssd.py``  — the frame-wide integer motion search (SSD table +
  two-pass argmin kernels), one search per P frame and reference.
* ``ops/sad.py``     — the full-search SAD-table kernel and its fused
  lambda·mv-bits argmin, used by the Python fallback inter encoder.
* ``ops/intra_screen.py`` — the I-slice 35-mode SATD prescreen kernel,
  one launch per block size, on every picture of an all-intra sequence.

``decoder/`` and ``cli/decode.py`` are a host-only copy of the reference's
decoder: they check the MD5 picture-hash SEI of every decoded picture.

Module names mirror ``hevc_tpu`` so each counterpart is easy to find. The
package never imports ``jax`` or ``hevc_tpu``. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when a card is asked for and none
is present.
"""

__version__ = "0.1.0"
