"""Fused tanh-RNN head (twin of tip_tpu/ops/pallas_kernels.py::fused_rnn).

    h_t = tanh(xin_t + h_{t-1} @ W_hh),  h_{-1} = 0

The RNN head is the one inherently sequential op of the model: each frame
pays T=40 dependent (B, H) x (H, H) steps. Kernel K1
(``csrc/fused_rnn.cu``) walks all T steps in one launch with the hidden
state in shared memory; ``fused_rnn_plain`` is the same function as a
Python loop over T.
"""

import ctypes

import torch

from tip_tpu_torch.ops import _kernels as K

_SIG = {"fused_rnn_launch": [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]}


def fused_rnn_plain(xin, w_hh):
    """Plain PyTorch version: xin (B, T, H) with both biases folded in,
    w_hh (H, H) stored (in, out). Returns the (B, T, H) hidden states."""
    B, T, H = xin.shape
    h = xin.new_zeros((B, H))
    hs = []
    for t in range(T):
        h = torch.tanh(xin[:, t] + h @ w_hh)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _launch(xin, w_hh):
    B, T, H = xin.shape
    K.check_input(xin, "xin", (B, T, H), torch.float32, xin.device)
    K.check_input(w_hh, "w_hh", (H, H), torch.float32, xin.device)
    out = torch.empty_like(xin)
    so = K.lib("fused_rnn", _SIG)
    stream = torch.cuda.current_stream(xin.device).cuda_stream
    err = so.fused_rnn_launch(xin.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                              B, T, H, stream)
    K.check(err, "fused_rnn")
    K.launch_counts["fused_rnn"] += 1
    return out


def fused_rnn(xin, w_hh, impl: str = "auto"):
    """The RNN head by ``impl``: "kernel" launches K1 (CUDA tensors only),
    "plain" runs ``fused_rnn_plain``, "auto" launches K1 for a CUDA tensor
    and runs the plain version for a CPU tensor."""
    if K.use_kernel(impl, xin, "rnn_impl", "kernel"):
        return _launch(xin, w_hh)
    return fused_rnn_plain(xin, w_hh)
