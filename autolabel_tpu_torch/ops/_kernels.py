"""Build, load and count the port's CUDA kernels.

Every source under csrc/ is compiled by nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes. Builds happen on
first use on a CUDA device, never at import, into build/torch_kernels/
beside the package; all sources compile in parallel, one nvcc process
each. A library whose source, shared headers (csrc/*.cuh) and flags are
unchanged is reused.

`launches` counts kernel launches by name. A wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its path
went through the kernels.
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'torch_kernels')
SOURCES = ('hashgrid_encode.cu', 'hashgrid_bwd.cu', 'hashgrid_atoms.cu',
           'hashgrid_sampled_bwd.cu', 'select_points.cu',
           'hashgrid_stochastic.cu', 'hashgrid_stochastic_bwd.cu',
           'heads_fwd.cu', 'heads_bwd.cu', 'mlp3.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

launches = collections.Counter()
build_log = {}  # source -> nvcc's stderr (ptxas register/spill report)
_libs = {}


def reset_launches():
    launches.clear()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build on a '
                           'machine with the CUDA toolkit')
    return path


def _target(source):
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith('.cuh'))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), 'rb') as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{digest.hexdigest()[:12]}.so')


def build_all():
    """Compile every source not yet built (in parallel) and load them all.
    Returns the wall seconds spent. Raises on any compile error."""
    start = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for source in SOURCES:
        target = _target(source)
        if os.path.exists(target):
            continue
        tmp = f'{target}.{os.getpid()}.tmp'
        procs[source] = (target, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for source, (target, tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_log[source] = out + err
        if proc.returncode != 0:
            failed.append(f'{source}:\n{out}{err}')
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    for source in SOURCES:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(_target(source))
    return time.perf_counter() - start


def library(source):
    """The loaded library of one source, building all on first use."""
    if source not in _libs:
        build_all()
    return _libs[source]


def check(status, name):
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {status}')
