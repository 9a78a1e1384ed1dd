"""What the benchmark takes from the measured program, the PyTorch and
CUDA port (``toc3d_tpu_torch``): its configuration, its detector built from
the benchmark's weights, its streaming entry point and its stage timer.
Every import of the program goes through here."""
from __future__ import annotations

import dataclasses
from dataclasses import replace

from . import encoders

# keys of a configuration file that describe it and are no field of the
# program's configuration
META_KEYS = ("name", "preset", "source", "reduced", "why", "views",
             "assumed", "encoder")


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    return o


def mismatches(file_cfg: dict, program_cfg: dict, path=""):
    """Keys where the configuration file and the program's configuration
    differ, or that one of them lacks (the file's own keys aside)."""
    out = []
    keys = set(program_cfg) | (set(file_cfg) - set(META_KEYS if not path
                                                  else ()))
    for k in sorted(keys):
        a, b = file_cfg.get(k, "<missing>"), program_cfg.get(k, "<missing>")
        if isinstance(a, dict) and isinstance(b, dict):
            out += mismatches(a, b, f"{path}{k}.")
        elif a != b:
            out.append(f"{path}{k}: file {a!r}, program {b!r}")
    return out


def program_config(file_cfg: dict, control: bool = False):
    """The program's configuration of the file's preset, checked key by key
    against the file; ``control``: the program's own int8 path switched on
    (the encoder's, perfbench/encoders, and the decoder's quant 'int8',
    dynamic scales)."""
    from toc3d_tpu_torch.configs import get_config
    cfg = get_config(file_cfg["preset"])
    bad = mismatches(file_cfg, _plain(dataclasses.asdict(cfg)))
    if bad:
        raise ValueError("configuration file differs from the program's "
                         f"preset {file_cfg['preset']!r}: " + "; ".join(bad))
    if control:
        cfg = encoders.load(file_cfg).control(cfg)
        cfg = replace(cfg, head=replace(cfg.head, decoder=replace(
            cfg.head.decoder, quant="int8")))
    return cfg


def build_kernels():
    from toc3d_tpu_torch.ops.cuda import build
    build.build_all()


def detector(cfg, state_dict, device):
    from toc3d_tpu_torch.models.detector import build_detector
    return build_detector(cfg, device=device, state_dict=state_dict)


def stage_timer(device):
    from toc3d_tpu_torch.runtime.timer import StageTimer
    return StageTimer(device)


def entry(model, timer=None):
    """``infer(state, frame) -> (state', boxes)``: the port's streaming
    entry point (captured CUDA graphs on the card)."""
    from toc3d_tpu_torch.models.detector import make_infer_fn
    return make_infer_fn(model, timer)


def initial_state(cfg, batch, device):
    from toc3d_tpu_torch.models.detector import init_state
    return init_state(batch, cfg, device=device)


BANK_FIELDS = ("embedding", "reference_point", "timestamp", "egopose",
               "velo")


def bank_of(state) -> dict:
    """The memory bank a state carries, by field name."""
    return dict(zip(BANK_FIELDS, state.memory))
