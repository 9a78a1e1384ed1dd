"""toc3d_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of toc3d_tpu.

Streaming multi-view ToC3D inference (EVA-02 ViT with motion-query-guided
token compression -> CPFPN -> StreamPETR head -> NMS-free decode). The JAX
package ``toc3d_tpu`` stays the reference; this package imports torch, numpy
and the standard library only, never jax or anything of ``toc3d_tpu``.

Layout mirrors the JAX package: ``configs/presets.py``, ``layers.py``,
``ops/`` (window, rope, resize, gather, posenc, attention and the kernel
wrappers), ``models/`` (eva_vit, token_select, toc3d_vit, neck,
petr_transformer, streampetr_head, detector), ``core/`` (coder, boxes),
``data/`` (nuScenes infos, eval frames, the eval sampler, synthetic
scenes), ``runtime/`` (the captured frame, timing, the streaming eval, the
detection metrics, the token visualizer), ``parallel/`` (data-parallel
training and view-sharded inference over torch.distributed),
``tracking/``, ``tools/`` (the eval and tracking CLIs), ``convert.py`` (JAX parameter tree or reference
checkpoint -> state dict) and ``csrc/`` (the CUDA sources of the four
Hopper kernels, built at first use by ``ops/cuda/build.py``).

Entry points put models and state on ``cuda`` unless the caller passes
``device="cpu"``. On the card every kernel launches its CUDA build; the plain
PyTorch version of a kernel runs only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"
