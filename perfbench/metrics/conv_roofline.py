"""The encoder's convolutions' share of their roofline: the least time a
frame of the convolutions that run on cuDNN's convolution kernels
(perfbench/encoders/vovnet.conv_launches: each one's operations, and its
input, weight and output once in bf16; perfbench/counting.least_time) over
the summed device time a traced frame of those kernels. None where the
trace holds none.

The kernels (NVIDIA H100, cuDNN 9.2): every 3x3 convolution and the 1x1
ones of stage 3 run cuDNN's implicit-GEMM forward kernels (names holding
'fprop'); the other 1x1 conv-BN-ReLUs run on cuBLASLt GEMMs with a fused
bias and ReLU epilogue ('relubias'), which no other launch of the frame
uses. The eSE gates' 1x1 convolutions and the neck's two laterals run on
plain cuBLASLt GEMMs that the head's linears share, with their bias added
apart: the match leaves them out, and so do the launches counted here.
"""
from .. import counting
from ..encoders import vovnet

LAYER = "kernels"
MOVES = "frames_per_s"
MATCH = ("fprop", "relubias")
EXCLUDE = ()
# the convolutions that run on other kernels (see the module note)
LEFT_OUT = (".ese.fc", "neck.lateral.")


def matched(name: str) -> bool:
    return any(m in name for m in MATCH) and not any(x in name
                                                      for x in EXCLUDE)


def launches(cfg, views, batch):
    """[(label, operations, bytes)] of the matched convolutions."""
    return [x for x in vovnet.conv_launches(cfg, views, batch)
            if not any(s in x[0] for s in LEFT_OUT)]


def read(ctx):
    measured = sum(e - s for n, s, e in ctx.kernels if matched(n)) * 1e-6
    if not ctx.trace_frames or measured <= 0:
        return None
    bound = sum(counting.least_time(f, b)
                for _, f, b in launches(ctx.cfg, ctx.views, ctx.batch))
    return 100.0 * bound / (measured / ctx.trace_frames)
