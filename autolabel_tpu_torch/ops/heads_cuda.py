"""The fused head-stack and 3-matrix MLP kernels (csrc/heads_fwd.cu).

Counterpart of autolabel_tpu/ops/heads_pallas.py, forward only. The
packing contract is the JAX package's: `pack_head_weights` zero-pads the
14 head matrices and `fused_heads(packed, A, B)` takes A (N, Dg), the
hash-grid encode, and B (N, Bw) with the frequency encode in columns
[0:freq) and the SH encode in columns [16:32), and returns
  out1 (N, Rw): col 0 sigma (trunc_exp applied), cols 1..3 rgb, rest 0,
  features (N, Sp) and logits (N, Cp).
The packing pads to 16, the card's MMA tile, where the JAX package pads to
the TPU's 128 lanes, so no MMA runs on padding; every real block sits
where the JAX packing puts it. Every padded weight is zero outside its
real block, so padding columns of every activation stay exactly zero.

On CPU tensors the wrappers compute the plain PyTorch versions; on CUDA
tensors they launch the kernels or raise.
"""
import ctypes

import torch

from autolabel_tpu_torch.ops import _kernels
from autolabel_tpu_torch.ops.activation import trunc_exp
from autolabel_tpu_torch.ops.mlp import dot, mlp_apply

HEADS = 'fused_heads'
MLP3 = 'fused_mlp3'
_SOURCE = 'heads_fwd.cu'
_SH_OFFSET = 16  # SH block starts at col 16 of B (freq occupies < 16)
_MAX_WIDTH = 128  # MAX_FRAGS * 16 in the kernel source
_LANE = 16  # the padding granule: the kernels' MMA tile


def _round(d):
    return ((d + _LANE - 1) // _LANE) * _LANE


def _pad_to(mat, rows, cols, row0=0):
    out = mat.new_zeros((rows, cols))
    out[row0:row0 + mat.shape[0], :mat.shape[1]] = mat
    return out


def supported(params, freq_dim):
    """The fused kernel covers the reference head topology (2 hidden
    sigma/color layers, 2 semantic-feature layers, 1 logits layer)."""
    try:
        return (len(params['sigma_net']) == 3
                and len(params['color_net']) == 3
                and len(params['semantic_features']) == 3
                and len(params['semantic_out']) == 2
                and freq_dim <= _SH_OFFSET
                and params['sigma_net'][2].shape[1] <= 128
                and params['color_net'][0].shape[0] == 16 +
                params['sigma_net'][2].shape[1] - 1)
    except (KeyError, IndexError, TypeError):
        return False


def pack_head_weights(params, freq_dim):
    """Params tree -> tuple of 14 zero-padded matrices (heads_pallas order:
    WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo, W1o)."""
    Ws0, Ws1, Ws2 = params['sigma_net']
    Wc0, Wc1, Wc2 = params['color_net']
    Wf0, Wf1, Wf2 = params['semantic_features']
    Wo0, Wo1 = params['semantic_out']
    S = Wf2.shape[1]                  # semantic feature dim
    H = _round(Ws1.shape[0])
    Hc = _round(Wc1.shape[0])
    Hf = _round(Wf1.shape[0])
    Ho = _round(Wo0.shape[1])
    Sp = _round(S)
    Cp = _round(Wo1.shape[1])
    Ap = _round(Ws0.shape[0] - freq_dim)  # grid segment
    Bw = _round(_SH_OFFSET + 16)  # extras block
    Sw = _round(Ws2.shape[1])     # [raw sigma, geo] block
    Rw = _round(4)                # [sigma, rgb] block
    return (
        _pad_to(Ws0[freq_dim:], Ap, H),                 # WA
        _pad_to(Ws0[:freq_dim], Bw, H),                 # WBs
        _pad_to(Ws1, H, H),                             # W1s
        _pad_to(Ws2, H, Sw),                            # W2s
        _pad_to(Wc0[:16], Bw, Hc, row0=_SH_OFFSET),     # WBc (SH rows)
        _pad_to(Wc0[16:], Sw, Hc, row0=1),              # WSc (geo rows)
        _pad_to(Wc1, Hc, Hc),                           # W1c
        _pad_to(Wc2, Hc, Rw),                           # W2c
        _pad_to(Wf0, Sw, Hf, row0=1),                   # WSf
        _pad_to(Wf1, Hf, Hf),                           # W1f
        _pad_to(Wf2, Hf, Sp),                           # W2f
        _pad_to(Wo0[:S], Sp, Ho),                       # WFo
        _pad_to(Wo0[S:], Sw, Ho, row0=1),               # WSo
        _pad_to(Wo1, Ho, Cp),                           # W1o
    )


def _pad_cols(m, cols):
    if m.shape[1] == cols:
        return m
    return torch.nn.functional.pad(m, (0, cols - m.shape[1]))


def fused_heads_plain(packed, A, B, compute_dtype=torch.float32):
    """The plain PyTorch version of the fused head kernel, on any device:
    the same stack, with operands rounded to compute_dtype and fp32
    accumulation (bf16 mirrors the kernel on the card)."""
    (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
     W1o) = packed
    A = _pad_cols(A, WA.shape[0])
    B = _pad_cols(B, WBs.shape[0])

    def d(a, b):
        return dot(a, b, compute_dtype)

    h1s = torch.relu(d(A, WA) + d(B, WBs))
    h2s = torch.relu(d(h1s, W1s))
    S = d(h2s, W2s)
    c1 = torch.relu(d(B, WBc) + d(S, WSc))
    c2 = torch.relu(d(c1, W1c))
    R = d(c2, W2c)
    f1 = torch.relu(d(S, WSf))
    f2 = torch.relu(d(f1, W1f))
    F = d(f2, W2f)
    o1 = torch.relu(d(torch.relu(F), WFo) + d(S, WSo))
    L = d(o1, W1o)
    out1 = torch.zeros((A.shape[0], W2c.shape[1]), dtype=torch.float32,
                       device=A.device)
    out1[:, 0] = torch.exp(torch.clamp(S[:, 0], max=15.0))
    out1[:, 1:4] = torch.sigmoid(R[:, :3])
    return out1, F, L


def heads_reference(params, freq_dim, A, B):
    """Reference of the fused op's contract through the field's own math
    (mlp_apply chains), consuming the same A/B blocks and returning the
    same (out1, features, logits) blocks (out1 128 wide)."""
    freq = B[:, :freq_dim]
    sh = B[:, _SH_OFFSET:_SH_OFFSET + 16]
    h = mlp_apply(params['sigma_net'], [freq, A])
    sigma = trunc_exp(h[..., 0])
    geo = h[..., 1:]
    rgb = torch.sigmoid(mlp_apply(params['color_net'], [sh, geo]))
    sem_features = mlp_apply(params['semantic_features'], geo)
    logits = mlp_apply(params['semantic_out'],
                       [torch.relu(sem_features), geo])
    out1 = torch.zeros((A.shape[0], 128), dtype=torch.float32,
                       device=A.device)
    out1[:, 0] = sigma
    out1[:, 1:4] = rgb
    return out1, sem_features, logits


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_points(name, device, *tensors):
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous 2-D float32 '
                             f'tensors on {device}')


def _kernel_weights(name, packed, device):
    """The packed weights in bf16 (no copy when the caller packed and cast
    them once, as Field does); every layer width must be a multiple of 16
    and at most 128 (the kernel's tile and fragment limits), and input
    widths multiples of 16."""
    for w in packed:
        if w.device != device or w.dim() != 2:
            raise ValueError(f'{name}: weights must be 2-D on {device}')
        if w.shape[0] % 16 or w.shape[1] % 16 or w.shape[1] > _MAX_WIDTH:
            raise ValueError(
                f'{name}: weight of shape {tuple(w.shape)} is outside the '
                'kernel (widths must be multiples of 16, outputs at most '
                f'{_MAX_WIDTH})')
    return [w.to(torch.bfloat16).contiguous() for w in packed]


def _heads_launch(packed, A, B):
    device = A.device
    _check_points(HEADS, device, A, B)
    ws = _kernel_weights(HEADS, packed, device)
    dims = (ws[0].shape[0], ws[1].shape[0], ws[2].shape[1], ws[3].shape[1],
            ws[6].shape[1], ws[7].shape[1], ws[9].shape[1], ws[10].shape[1],
            ws[13].shape[0], ws[13].shape[1], A.shape[1], B.shape[1])
    Ap, Bw, H, Sw, Hc, Rw, Hf, Sp, Ho, Cp = dims[:10]
    shapes = ((Ap, H), (Bw, H), (H, H), (H, Sw), (Bw, Hc), (Sw, Hc),
              (Hc, Hc), (Hc, Rw), (Sw, Hf), (Hf, Hf), (Hf, Sp), (Sp, Ho),
              (Sw, Ho), (Ho, Cp))
    if tuple(tuple(w.shape) for w in ws) != shapes:
        raise ValueError(f'{HEADS}: packed weights are inconsistent')
    if A.shape[1] > Ap or B.shape[1] > Bw or A.shape[0] != B.shape[0] \
            or Rw < 4:
        raise ValueError(f'{HEADS}: A/B widths do not fit the packing')
    n = A.shape[0]
    out1 = torch.empty((n, Rw), dtype=torch.float32, device=device)
    outf = torch.empty((n, Sp), dtype=torch.float32, device=device)
    outl = torch.empty((n, Cp), dtype=torch.float32, device=device)
    fn = _kernels.library(_SOURCE).heads_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(A.data_ptr(), B.data_ptr(), _ptr_array(ws),
                (ctypes.c_int * 12)(*dims), out1.data_ptr(),
                outf.data_ptr(), outl.data_ptr(), n, stream)
    _kernels.check(status, HEADS)
    _kernels.launches[HEADS] += 1
    return out1, outf, outl


class _FusedHeads(torch.autograd.Function):
    """The head kernel's forward; its backward kernel belongs to the
    training slice."""

    @staticmethod
    def forward(ctx, A, B, *packed):
        return _heads_launch(packed, A, B)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError('the fused head backward is not ported yet')


def fused_heads(packed, A, B):
    """(out1, features, logits) of the head stack: the plain version on
    the CPU (fp32, the JAX package's CPU rule), the CUDA kernel (bf16
    operands, fp32 accumulation) on the card."""
    if A.device.type == 'cpu':
        return fused_heads_plain(packed, A, B)
    return _FusedHeads.apply(A, B, *packed)


# ---------------------------------------------------------------- mlp3
# A fused 3-matrix ReLU MLP (in -> h -> h -> out), used for the proposal
# density net (36 -> 64 -> 64 -> 1, models/field.py proposal_sigma).


def pack_mlp3(weights):
    """[W0, W1, W2] -> zero-padded matrices."""
    W0, W1, W2 = weights
    Din = _round(W0.shape[0])
    H = _round(W1.shape[0])
    Dout = _round(W2.shape[1])
    return (_pad_to(W0, Din, H), _pad_to(W1, H, H), _pad_to(W2, H, Dout))


def fused_mlp3_plain(packed, X, compute_dtype=torch.float32):
    """The plain PyTorch version of the mlp3 kernel, on any device."""
    W0, W1, W2 = packed
    X = _pad_cols(X, W0.shape[0])
    h1 = torch.relu(dot(X, W0, compute_dtype))
    h2 = torch.relu(dot(h1, W1, compute_dtype))
    return dot(h2, W2, compute_dtype)


def _mlp3_launch(packed, X):
    device = X.device
    _check_points(MLP3, device, X)
    W0, W1, W2 = _kernel_weights(MLP3, packed, device)
    d_in, hidden = W0.shape
    d_out = W2.shape[1]
    if W1.shape != (hidden, hidden) or W2.shape[0] != hidden \
            or X.shape[1] > d_in:
        raise ValueError(f'{MLP3}: weights and X are inconsistent')
    n = X.shape[0]
    out = torch.empty((n, d_out), dtype=torch.float32, device=device)
    fn = _kernels.library(_SOURCE).mlp3_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(X.data_ptr(), X.shape[1], W0.data_ptr(), W1.data_ptr(),
                W2.data_ptr(), d_in, hidden, d_out, out.data_ptr(), n,
                stream)
    _kernels.check(status, MLP3)
    _kernels.launches[MLP3] += 1
    return out


class _FusedMLP3(torch.autograd.Function):
    """The mlp3 kernel's forward; its backward kernel belongs to the
    training slice."""

    @staticmethod
    def forward(ctx, X, *packed):
        return _mlp3_launch(packed, X)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError('the fused mlp3 backward is not ported yet')


def fused_mlp3(packed, X):
    """relu(relu(X.W0).W1).W2: the plain version on the CPU, the CUDA
    kernel on the card."""
    if X.device.type == 'cpu':
        return fused_mlp3_plain(packed, X)
    return _FusedMLP3.apply(X, *packed)
