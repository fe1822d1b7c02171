"""The fused head-stack and 3-matrix MLP kernels: csrc/heads_fwd.cu (K3f),
csrc/heads_bwd.cu (K3b) and csrc/mlp3.cu (K4f, K4b).

Counterpart of autolabel_tpu/ops/heads_pallas.py, forward and backward.
The packing contract is the JAX package's: `pack_head_weights` zero-pads
the 14 head matrices and `fused_heads(packed, A, B)` takes A (N, Dg), the
hash-grid encode, and B (N, Bw) with the frequency encode in columns
[0:freq) and the SH encode in columns [16:32), and returns
  out1 (N, Rw): col 0 sigma (trunc_exp applied), cols 1..3 rgb, rest 0,
  features (N, Sp) and logits (N, Cp).
The packing pads to 16, the card's MMA tile, where the JAX package pads to
the TPU's 128 lanes, so no MMA runs on padding; every real block sits
where the JAX packing puts it. Every padded weight is zero outside its
real block, so padding columns of every activation stay exactly zero.

Both ops are differentiable (autograd.Functions whose backward is the
backward kernel, as the JAX package's custom VJPs run `_bwd_kernel` and
`_mlp3_bwd_kernel`). On CPU tensors the wrappers compute the plain PyTorch
versions, forward and backward; on CUDA tensors they launch the kernels or
raise.
"""
import ctypes

import torch

from autolabel_tpu_torch.ops import _kernels
from autolabel_tpu_torch.ops.activation import trunc_exp
from autolabel_tpu_torch.ops.mlp import dot, mlp_apply

HEADS = 'fused_heads'
HEADS_BWD = 'fused_heads_bwd'
MLP3 = 'fused_mlp3'
MLP3_BWD = 'fused_mlp3_bwd'
_SOURCE = 'heads_fwd.cu'
_BWD_SOURCE = 'heads_bwd.cu'
_MLP3_SOURCE = 'mlp3.cu'
_SH_OFFSET = 16  # SH block starts at col 16 of B (freq occupies < 16)
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


def _forward_blocks(packed, A, B, compute_dtype):
    """The stack on (N, .) blocks with A and B padded to the packing;
    returns every activation the backward needs (heads_pallas
    _forward_blocks)."""
    (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
     W1o) = packed

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
    return h1s, h2s, S, c1, c2, R, f1, f2, F, o1, L


def fused_heads_plain(packed, A, B, compute_dtype=torch.float32):
    """The plain PyTorch version of the fused head kernel, on any device:
    the same stack, with operands rounded to compute_dtype and fp32
    accumulation (bf16 mirrors the kernel on the card)."""
    A = _pad_cols(A, packed[0].shape[0])
    B = _pad_cols(B, packed[1].shape[0])
    _, _, S, _, _, R, _, _, F, _, L = _forward_blocks(packed, A, B,
                                                      compute_dtype)
    out1 = torch.zeros((A.shape[0], packed[7].shape[1]), dtype=torch.float32,
                       device=A.device)
    out1[:, 0] = torch.exp(torch.clamp(S[:, 0], max=15.0))
    out1[:, 1:4] = torch.sigmoid(R[:, :3])
    return out1, F, L


def fused_heads_backward_plain(packed, A, B, g1, gf, gl,
                               compute_dtype=torch.float32):
    """The plain PyTorch version of the fused head backward kernel, on any
    device: recomputes the activations and returns (dA, dB, 14 dW) for the
    cotangents g1 (N, Rw), gf (N, Sp), gl (N, Cp) of the three outputs,
    as heads_pallas._bwd_kernel computes them (the trunc_exp VJP
    g * exp(clip(S0, -15, 15)), the sigmoid VJP on rgb, operands rounded to
    compute_dtype, fp32 accumulation)."""
    a_cols, b_cols = A.shape[1], B.shape[1]
    A = _pad_cols(A, packed[0].shape[0])
    B = _pad_cols(B, packed[1].shape[0])
    dA, dB, dws = _backward_blocks(
        packed, A, B, _forward_blocks(packed, A, B, compute_dtype), g1, gf,
        gl, compute_dtype)
    return dA[:, :a_cols], dB[:, :b_cols], dws


def _backward_blocks(packed, A, B, acts, g1, gf, gl, compute_dtype):
    """The stack's backward on A and B padded to the packing, from the
    activations acts that _forward_blocks returns (its ReLU masks are
    theirs): (dA, dB, 14 dW), dA and dB as wide as the padding."""
    (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
     W1o) = packed
    h1s, h2s, S, c1, c2, R, f1, f2, F, o1, _ = acts

    def nt(a, b):  # a @ b.T
        return dot(a, b.T, compute_dtype)

    def tn(a, b):  # a.T @ b
        return dot(a.T, b, compute_dtype)

    dsig = g1[:, :1] * torch.exp(torch.clamp(S[:, :1], -15.0, 15.0))
    rgb = torch.sigmoid(R[:, :3])
    dR = torch.zeros_like(R)
    dR[:, :3] = g1[:, 1:4] * rgb * (1.0 - rgb)
    # logits head
    do1 = nt(gl, W1o) * (o1 > 0)
    dW1o = tn(o1, gl)
    dWFo = tn(torch.relu(F), do1)
    dWSo = tn(S, do1)
    # feature head (+ the relu(F) branch into the logits head)
    dF = gf + nt(do1, WFo) * (F > 0)
    df2 = nt(dF, W2f) * (f2 > 0)
    dW2f = tn(f2, dF)
    df1 = nt(df2, W1f) * (f1 > 0)
    dW1f = tn(f1, df2)
    dWSf = tn(S, df1)
    # color head
    dc2 = nt(dR, W2c) * (c2 > 0)
    dW2c = tn(c2, dR)
    dc1 = nt(dc2, W1c) * (c1 > 0)
    dW1c = tn(c1, dc2)
    dWBc = tn(B, dc1)
    dWSc = tn(S, dc1)
    # every path into dS, then the sigma trunk
    dS = nt(dc1, WSc) + nt(df1, WSf) + nt(do1, WSo)
    dS[:, :1] = dS[:, :1] + dsig
    dh2s = nt(dS, W2s) * (h2s > 0)
    dW2s = tn(h2s, dS)
    dh1s = nt(dh2s, W1s) * (h1s > 0)
    dW1s = tn(h1s, dh2s)
    dWA = tn(A, dh1s)
    dWBs = tn(B, dh1s)
    dA = nt(dh1s, WA)
    dB = nt(dh1s, WBs) + nt(dc1, WBc)
    return dA, dB, (dWA, dWBs, dW1s, dW2s, dWBc, dWSc, dW1c, dW2c, dWSf,
                    dW1f, dW2f, dWFo, dWSo, dW1o)


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
    """The packed weights in bf16, the kernels' operand type (no copy when
    the caller packed and cast them once, as Field does for serving); every
    width must be a multiple of 16, the kernels' tile."""
    for w in packed:
        if w.device != device or w.dim() != 2:
            raise ValueError(f'{name}: weights must be 2-D on {device}')
        if w.shape[0] % _LANE or w.shape[1] % _LANE:
            raise ValueError(
                f'{name}: weight of shape {tuple(w.shape)} is outside the '
                f'kernel (widths must be multiples of {_LANE})')
    return [w.detach().to(torch.bfloat16).contiguous() for w in packed]


def _heads_dims(ws, A, B):
    """The kernels' 12 dims, checked against the packing contract."""
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
    return dims


def _heads_launch(ws, A, B):
    """K3f on bf16 packed weights ws."""
    device = A.device
    _check_points(HEADS, device, A, B)
    dims = _heads_dims(ws, A, B)
    Rw, Sp, Cp = dims[5], dims[7], dims[9]
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


_WORKSPACE_OUT = [ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_longlong)]


def _workspace(name, fn, args):
    """(blocks, total floats) of a persistent backward kernel's per-block
    weight-gradient partials, from its workspace query."""
    blocks, total = ctypes.c_int(0), ctypes.c_longlong(0)
    fn.restype = ctypes.c_int
    _kernels.check(fn(*args, ctypes.byref(blocks), ctypes.byref(total)), name)
    return blocks.value, total.value


def _split(flat, shapes):
    out, o = [], 0
    for r, c in shapes:
        out.append(flat[o:o + r * c].view(r, c))
        o += r * c
    return out


def _grads(name, n, widths, device, *grads):
    """Cotangents as contiguous fp32 (N, width) tensors."""
    out = []
    for g, width in zip(grads, widths):
        if g.shape != (n, width):
            raise ValueError(f'{name}: cotangent of shape {tuple(g.shape)}, '
                             f'expected {(n, width)}')
        out.append(g.to(device=device, dtype=torch.float32).contiguous())
    return out


def _heads_backward_launch(ws, A, B, g1, gf, gl, need_dB=True):
    """K3b on bf16 packed weights ws: (dA, dB or None, 14 fp32 dW)."""
    device = A.device
    _check_points(HEADS_BWD, device, A, B)
    dims = _heads_dims(ws, A, B)
    n = A.shape[0]
    g1, gf, gl = _grads(HEADS_BWD, n, (dims[5], dims[7], dims[9]), device,
                        g1, gf, gl)
    lib = _kernels.library(_BWD_SOURCE)
    c_dims = (ctypes.c_int * 12)(*dims)
    part_floats, work_elems = ctypes.c_longlong(0), ctypes.c_longlong(0)
    query = lib.heads_bwd_workspace
    query.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p]
    query.restype = ctypes.c_int
    _kernels.check(query(c_dims, n, ctypes.byref(part_floats),
                         ctypes.byref(work_elems)), HEADS_BWD)
    work = torch.empty(work_elems.value, dtype=torch.bfloat16, device=device)
    part = torch.empty(part_floats.value, dtype=torch.float32, device=device)
    dW = torch.empty(sum(w.numel() for w in ws), dtype=torch.float32,
                     device=device)
    dA = torch.empty((n, A.shape[1]), dtype=torch.float32, device=device)
    dB = (torch.empty((n, B.shape[1]), dtype=torch.float32, device=device)
          if need_dB else None)
    fn = lib.heads_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(A.data_ptr(), B.data_ptr(), _ptr_array(ws), c_dims,
                g1.data_ptr(), gf.data_ptr(), gl.data_ptr(), dA.data_ptr(),
                None if dB is None else dB.data_ptr(), dW.data_ptr(),
                part.data_ptr(), work.data_ptr(), n, stream)
    _kernels.check(status, HEADS_BWD)
    _kernels.launches[HEADS_BWD] += 1
    return dA, dB, _split(dW, [tuple(w.shape) for w in ws])


def heads_launch_shapes(packed, A, B, need_dB=True):
    """The launch shapes of K3f and K3b (its fused kernel, da_kernel and
    its two dw_kernel launches: dWA, and the other 13 weight gradients)
    for these inputs, as the C library plans them: blocks, threads,
    dynamic shared bytes, blocks per SM, registers per thread and schedule
    steps (for da_kernel: chunks of K; for dw_kernel: splits of the
    points)."""
    ws = _kernel_weights(HEADS, packed, A.device)
    dims = (ctypes.c_int * 12)(*_heads_dims(ws, A, B))
    n = A.shape[0]
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'steps')
    out = (ctypes.c_int * 24)()
    fwd = _kernels.library(_SOURCE).heads_fwd_shape
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    _kernels.check(fwd(dims, n, out), HEADS)
    shapes = {'heads_fwd_kernel': dict(zip(keys, out[:6]))}
    bwd = _kernels.library(_BWD_SOURCE).heads_bwd_shape
    bwd.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    _kernels.check(bwd(dims, n, need_dB, out), HEADS_BWD)
    shapes['heads_bwd_kernel'] = dict(zip(keys, out[:6]))
    shapes['da_kernel'] = dict(zip(keys[:5] + ('chunks',), out[6:12]))
    split = keys[:5] + ('splits',)
    shapes['dw_kernel dWA'] = dict(zip(split, out[12:18]))
    shapes['dw_kernel others'] = dict(zip(split, out[18:24]))
    return shapes


def _in_dtypes(dws, dtypes):
    """Weight gradients in the dtypes of the weights the caller passed:
    fp32 for the fp32 weights of the training path, as the JAX package
    keeps dW in the weights' dtype."""
    return [d if d.dtype == t else d.to(t) for d, t in zip(dws, dtypes)]


def fused_heads_backward(packed, A, B, g1, gf, gl, need_dB=True):
    """(dA, dB, 14 fp32 dW) of the head stack for the cotangents of its
    three outputs: the plain version on the CPU, K3b on the card (dB None
    when not needed)."""
    if A.device.type == 'cpu':
        return fused_heads_backward_plain(packed, A, B, g1, gf, gl)
    return _heads_backward_launch(_kernel_weights(HEADS_BWD, packed,
                                                  A.device),
                                  A, B, g1, gf, gl, need_dB)


class _FusedHeads(torch.autograd.Function):
    """The head stack with its backward: the plain versions on the CPU,
    K3f and K3b on the card. Takes the packed weights in their own dtype
    (fp32 while training) and casts to bf16 inside, so the weight
    gradients come back in fp32."""

    @staticmethod
    def forward(ctx, A, B, *packed):
        if A.device.type == 'cpu':
            ws = packed
            out = fused_heads_plain(ws, A, B)
        else:
            ws = _kernel_weights(HEADS, packed, A.device)
            out = _heads_launch(ws, A, B)
        ctx.save_for_backward(A, B, *ws)
        ctx.weight_dtypes = [w.dtype for w in packed]
        return out

    @staticmethod
    def backward(ctx, g1, gf, gl):
        A, B, *ws = ctx.saved_tensors
        dA, dB, dws = fused_heads_backward(ws, A, B, g1, gf, gl,
                                           ctx.needs_input_grad[1])
        dws = _in_dtypes(dws, ctx.weight_dtypes)
        return (dA if ctx.needs_input_grad[0] else None,
                dB if ctx.needs_input_grad[1] else None, *dws)


def fused_heads(packed, A, B):
    """(out1, features, logits) of the head stack: the plain version on
    the CPU (fp32, the JAX package's CPU rule), the CUDA kernels (bf16
    operands, fp32 accumulation) on the card; differentiable in A, B and
    the packed weights."""
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


def fused_mlp3_backward_plain(packed, X, g, compute_dtype=torch.float32):
    """The plain PyTorch version of the mlp3 backward kernel, on any
    device: (dX, (dW0, dW1, dW2)) for the cotangent g (N, Dout), as
    heads_pallas._mlp3_bwd_kernel computes them."""
    W0, W1, W2 = packed
    x_cols = X.shape[1]
    X = _pad_cols(X, W0.shape[0])
    h1 = torch.relu(dot(X, W0, compute_dtype))
    h2 = torch.relu(dot(h1, W1, compute_dtype))
    dh2 = dot(g, W2.T, compute_dtype) * (h2 > 0)
    dh1 = dot(dh2, W1.T, compute_dtype) * (h1 > 0)
    dX = dot(dh1, W0.T, compute_dtype)[:, :x_cols]
    return dX, (dot(X.T, dh1, compute_dtype), dot(h1.T, dh2, compute_dtype),
                dot(h2.T, g, compute_dtype))


def _mlp3_dims(ws, X):
    W0, W1, W2 = ws
    d_in, hidden = W0.shape
    if W1.shape != (hidden, hidden) or W2.shape[0] != hidden \
            or X.shape[1] > d_in:
        raise ValueError(f'{MLP3}: weights and X are inconsistent')
    return d_in, hidden, W2.shape[1]


_MLP3_SHAPE_KEYS = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm',
                    'registers', 'tile_points', 'smem_limit', 'max_hidden')
_INVALID_VALUE = 1  # cudaErrorInvalidValue: the C library refuses the widths


def _mlp3_shape(d_in, hidden, d_out, n):
    """K4f's launch shape for these widths and n points, as the C library
    plans it; raises ValueError for widths the kernel does not take."""
    fn = _kernels.library(_MLP3_SOURCE).mlp3_fwd_shape
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_MLP3_SHAPE_KEYS))()
    status = fn(d_in, hidden, d_out, n, out)
    shape = dict(zip(_MLP3_SHAPE_KEYS, out))
    if status == _INVALID_VALUE:
        raise ValueError(
            f'{MLP3}: widths {d_in}-{hidden}-{hidden}-{d_out} are outside the '
            f'kernel: multiples of 16, hidden at most {shape["max_hidden"]}, '
            f'and weights and X stages within the shared memory per block '
            f'({shape["smem_bytes"]} bytes needed, the card allows '
            f'{shape["smem_limit"]})')
    _kernels.check(status, MLP3)
    return shape


def _mlp3_launch(ws, X):
    """K4f on bf16 packed weights ws."""
    device = X.device
    _check_points(MLP3, device, X)
    d_in, hidden, d_out = _mlp3_dims(ws, X)
    n = X.shape[0]
    out = torch.empty((n, d_out), dtype=torch.float32, device=device)
    fn = _kernels.library(_MLP3_SOURCE).mlp3_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(X.data_ptr(), X.shape[1], *[w.data_ptr() for w in ws],
                d_in, hidden, d_out, out.data_ptr(), n, stream)
    if status == _INVALID_VALUE:
        _mlp3_shape(d_in, hidden, d_out, n)  # raises with the reason
    _kernels.check(status, MLP3)
    _kernels.launches[MLP3] += 1
    return out


def mlp3_launch_shapes(packed, X):
    """K4f's launch shape for these inputs, as the C library plans it:
    blocks, threads, dynamic shared bytes, blocks per SM, registers per
    thread, points per warp tile, the card's shared-memory limit and the
    widest hidden layer."""
    ws = _kernel_weights(MLP3, packed, X.device)
    return {'mlp3_fwd_kernel': _mlp3_shape(*_mlp3_dims(ws, X), X.shape[0])}


def _mlp3_backward_launch(ws, X, g, need_dX=True):
    """K4b on bf16 packed weights ws: (dX or None, 3 fp32 dW)."""
    device = X.device
    _check_points(MLP3_BWD, device, X)
    d_in, hidden, d_out = _mlp3_dims(ws, X)
    n = X.shape[0]
    (g,) = _grads(MLP3_BWD, n, (d_out,), device, g)
    lib = _kernels.library(_MLP3_SOURCE)
    query = lib.mlp3_bwd_workspace
    query.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong,
                                           *_WORKSPACE_OUT]
    blocks, total = _workspace(MLP3_BWD, query, (d_in, hidden, d_out, n))
    part = torch.empty(blocks * total, dtype=torch.float32, device=device)
    dW = torch.empty(total, dtype=torch.float32, device=device)
    dX = (torch.empty((n, X.shape[1]), dtype=torch.float32, device=device)
          if need_dX else None)
    fn = lib.mlp3_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(X.data_ptr(), X.shape[1], *[w.data_ptr() for w in ws],
                d_in, hidden, d_out, g.data_ptr(),
                None if dX is None else dX.data_ptr(), dW.data_ptr(),
                part.data_ptr(), blocks, n, stream)
    _kernels.check(status, MLP3_BWD)
    _kernels.launches[MLP3_BWD] += 1
    return dX, _split(dW, [tuple(w.shape) for w in ws])


def fused_mlp3_backward(packed, X, g, need_dX=True):
    """(dX, (dW0, dW1, dW2) fp32) of the mlp3 for the cotangent g: the
    plain version on the CPU, K4b on the card (dX None when not needed)."""
    if X.device.type == 'cpu':
        return fused_mlp3_backward_plain(packed, X, g)
    return _mlp3_backward_launch(_kernel_weights(MLP3_BWD, packed, X.device),
                                 X, g, need_dX)


class _FusedMLP3(torch.autograd.Function):
    """The mlp3 with its backward: the plain versions on the CPU, K4f and
    K4b on the card; weights cast to bf16 inside, as _FusedHeads."""

    @staticmethod
    def forward(ctx, X, *packed):
        if X.device.type == 'cpu':
            ws = packed
            out = fused_mlp3_plain(ws, X)
        else:
            ws = _kernel_weights(MLP3, packed, X.device)
            out = _mlp3_launch(ws, X)
        ctx.save_for_backward(X, *ws)
        ctx.weight_dtypes = [w.dtype for w in packed]
        return out

    @staticmethod
    def backward(ctx, g):
        X, *ws = ctx.saved_tensors
        dX, dws = fused_mlp3_backward(ws, X, g, ctx.needs_input_grad[0])
        dws = _in_dtypes(dws, ctx.weight_dtypes)
        return (dX if ctx.needs_input_grad[0] else None, *dws)


def fused_mlp3(packed, X):
    """relu(relu(X.W0).W1).W2: the plain version on the CPU, the CUDA
    kernels on the card; differentiable in X and the packed weights."""
    return _FusedMLP3.apply(X, *packed)
