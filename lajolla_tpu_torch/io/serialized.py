"""Mitsuba `.serialized` mesh loader (host-side).

Format (replicating src/load_serialized.cpp): little-endian; file =
[u16 magic][u16 version] then per-shape zlib streams; a footer holds
[u64/u32 offsets...][u32 count]. Each shape stream: u32 flags,
(v4: null-terminated name), u64 vertex_count, u64 triangle_count,
positions (f32/f64 xyz), optional normals/uvs/colors, then u32x3 indices.
"""

import zlib

import numpy as np

MTS_V3, MTS_V4 = 0x0003, 0x0004

F_HAS_NORMALS = 0x0001
F_HAS_TEXCOORDS = 0x0002
F_HAS_COLORS = 0x0008
F_FACE_NORMALS = 0x0010
F_SINGLE = 0x1000
F_DOUBLE = 0x2000


def load_serialized(path, shape_index=0, to_world=None):
    with open(path, 'rb') as f:
        data = f.read()
    version = int(np.frombuffer(data[2:4], '<u2')[0])

    offset = 4
    if shape_index > 0:
        count = int(np.frombuffer(data[-4:], '<u4')[0])
        if version == MTS_V4:
            table = np.frombuffer(data[-4 - 8 * count:-4], '<u8')
        else:
            table = np.frombuffer(data[-4 - 4 * count:-4], '<u4')
        offset = int(table[shape_index]) + 4  # skip per-shape header

    raw = zlib.decompressobj().decompress(data[offset:])
    pos = 0

    def take(n):
        nonlocal pos
        b = raw[pos:pos + n]
        pos += n
        return b

    flags = int(np.frombuffer(take(4), '<u4')[0])
    if version == MTS_V4:
        e = raw.index(b'\0', pos)
        pos = e + 1
    vcount = int(np.frombuffer(take(8), '<u8')[0])
    tcount = int(np.frombuffer(take(8), '<u8')[0])

    ftype = '<f8' if (flags & F_DOUBLE) else '<f4'
    fsize = 8 if (flags & F_DOUBLE) else 4

    positions = np.frombuffer(take(3 * fsize * vcount), ftype).reshape(
        vcount, 3).astype(np.float64)
    normals = None
    if flags & F_HAS_NORMALS:
        normals = np.frombuffer(take(3 * fsize * vcount), ftype).reshape(
            vcount, 3).astype(np.float64)
    uvs = None
    if flags & F_HAS_TEXCOORDS:
        uvs = np.frombuffer(take(2 * fsize * vcount), ftype).reshape(
            vcount, 2).astype(np.float64)
    if flags & F_HAS_COLORS:
        take(3 * fsize * vcount)  # ignored, as in the reference
    indices = np.frombuffer(take(12 * tcount), '<i4').reshape(
        tcount, 3).astype(np.int32)

    if to_world is not None:
        m = np.asarray(to_world, np.float64)
        positions = positions @ m[:3, :3].T + m[:3, 3]
        if normals is not None:
            inv = np.linalg.inv(m)
            normals = normals @ inv[:3, :3]
            lens = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = np.where(lens > 0, normals / np.maximum(lens, 1e-300),
                               normals)

    return dict(positions=positions, indices=indices,
                normals=normals, uvs=uvs)
