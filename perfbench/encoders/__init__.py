"""One module an image encoder (backbone and neck), found by the name under
the configuration file's key ``encoder``, so that a configuration with an
encoder of its own is new files only. A module gives:

* ``layout(cfg)``: [(name, shape, kind)] of the ``img_backbone.*`` and
  ``img_neck.*`` parameters in the order perfbench/weights.py draws them
  (kinds as there);
* ``features(sd, cfg, img, bank, frame)``: (B, N, H, W, 3) uint8 views ->
  the (B*N, h, w, C) level that the head reads, image normalisation
  included; plain float32 PyTorch, importing nothing of the program (the
  reference's part, perfbench/reference/model.py);
* ``flops(cfg, views, batch)``: the encoder's operations in one steady
  frame, counted as perfbench/counting.py counts;
* ``control(program_cfg)``: the program's configuration with the
  encoder's own int8 path switched on, or unchanged where it has none.

All but ``control`` take the configuration file's dict."""
from __future__ import annotations

import importlib
import re


def load(cfg: dict):
    """The encoder module that the configuration file names."""
    name = cfg.get("encoder")
    where = f"configuration {cfg.get('name')!r}, key 'encoder'"
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_]\w*", name):
        raise ValueError(f"{where}: {name!r} names no encoder module")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"{where}: {name!r}, but there is no "
                         f"perfbench/encoders/{name}.py") from None
