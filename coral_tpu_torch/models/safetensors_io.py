"""The safetensors file format, read with torch alone.

A file is an 8-byte little-endian header length N, N bytes of JSON (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` into the data that follows,
and an optional ``__metadata__`` of strings), then the tensors' bytes. The
reader maps the file and returns tensors that are views of the mapping: no
tensor is copied until it is copied to where it is used. The mapping is
private (copy on write), so nothing a caller does to a view reaches the file.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of the file at ``path`` as a CPU view of its mapping, in
    the file's dtype (F32, F16 or BF16; any other raises)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = (end - begin) // dtype.itemsize
        if count != (torch.Size(shape).numel()):
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes for "
                             f"shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=start + begin).view(shape)
    return out
