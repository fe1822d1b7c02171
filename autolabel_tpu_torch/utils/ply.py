"""Minimal PLY point-cloud/mesh vertex I/O (numpy only).

Counterpart of autolabel_tpu/utils/ply.py, kept as the port's own copy:
read_ply_vertices reads the gt mesh's vertices for the 3D evaluator, and
write_ply_pointcloud writes the fused point cloud of
language/pointcloud.py, as the JAX package's do (open3d is not needed).
"""
import numpy as np

_PLY_DTYPES = {
    'char': 'i1', 'uchar': 'u1', 'short': 'i2', 'ushort': 'u2',
    'int': 'i4', 'uint': 'u4', 'int8': 'i1', 'uint8': 'u1',
    'int16': 'i2', 'uint16': 'u2', 'int32': 'i4', 'uint32': 'u4',
    'float': 'f4', 'double': 'f8', 'float32': 'f4', 'float64': 'f8',
}


def read_ply_vertices(path):
    """Read vertex x/y/z (float64 (N, 3)) from an ascii or binary PLY."""
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic != b'ply':
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertices = 0
        properties = []
        in_vertex_element = False
        while True:
            line = f.readline().decode('ascii').strip()
            if line == 'end_header':
                break
            parts = line.split()
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                in_vertex_element = parts[1] == 'vertex'
                if in_vertex_element:
                    n_vertices = int(parts[2])
            elif parts[0] == 'property' and in_vertex_element:
                if parts[1] == 'list':
                    raise ValueError("list property in vertex element")
                properties.append((parts[2], _PLY_DTYPES[parts[1]]))

        if fmt == 'ascii':
            rows = []
            for _ in range(n_vertices):
                rows.append(
                    [float(v) for v in f.readline().split()[:len(properties)]])
            data = np.asarray(rows)
            names = [name for name, _ in properties]
            idx = [names.index(c) for c in ('x', 'y', 'z')]
            return data[:, idx]

        endian = '<' if 'little' in fmt else '>'
        dtype = np.dtype([(name, endian + d) for name, d in properties])
        data = np.frombuffer(f.read(dtype.itemsize * n_vertices),
                             dtype=dtype, count=n_vertices)
        return np.stack([data['x'], data['y'], data['z']],
                        axis=-1).astype(np.float64)


def write_ply_pointcloud(path, points, colors=None):
    """Write a binary-little-endian PLY point cloud; colors in [0, 1]."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    header = ['ply', 'format binary_little_endian 1.0',
              f'element vertex {n}',
              'property float x', 'property float y', 'property float z']
    if colors is not None:
        header += ['property uchar red', 'property uchar green',
                   'property uchar blue']
    header.append('end_header')
    with open(path, 'wb') as f:
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        if colors is None:
            f.write(points.astype('<f4').tobytes())
        else:
            rgb = (np.clip(np.asarray(colors), 0.0, 1.0) * 255).astype('u1')
            dtype = np.dtype([('x', '<f4'), ('y', '<f4'), ('z', '<f4'),
                              ('r', 'u1'), ('g', 'u1'), ('b', 'u1')])
            rows = np.empty(n, dtype=dtype)
            rows['x'], rows['y'], rows['z'] = points.T
            rows['r'], rows['g'], rows['b'] = rgb.T
            f.write(rows.tobytes())
