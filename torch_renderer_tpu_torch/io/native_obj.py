"""Adapter between io/obj.py's native hook and the C++ parser (PyTorch
counterpart of ``torch_renderer_tpu.io.native_obj``).

load_obj() calls parse_obj(path) and takes ObjData-shaped fields from it,
or None, and then parses in Python.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from .native import parse_obj_bytes

_MTLLIB_RE = re.compile(rb"^[ \t]*mtllib[ \t]+(\S+)", re.MULTILINE)


def parse_obj(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        data = f.read()
    parsed = parse_obj_bytes(data)
    if parsed is None:
        return None
    m = _MTLLIB_RE.search(data)
    mtl_path = (
        os.path.join(os.path.dirname(path), m.group(1).decode(errors="ignore"))
        if m else None
    )
    uvs, faces_uv = parsed["uvs"], parsed["faces_uv"]
    has_uv = (uvs.shape[0] > 0 and faces_uv.shape[0] > 0
              and bool((faces_uv >= 0).all()))
    normals = parsed["normals"]
    return {
        "verts": parsed["verts"],
        "faces": np.ascontiguousarray(parsed["faces"]),
        "verts_uvs": uvs if has_uv else None,
        "faces_uvs": np.ascontiguousarray(faces_uv) if has_uv else None,
        "normals": normals if normals.shape[0] > 0 else None,
        "mtl_path": mtl_path,
    }
