"""The plain reference the benchmark holds the program to: plain PyTorch
and NumPy, importing nothing of the program and nothing of JAX, written
from the semantics of ContextGS and of 3D Gaussian Splatting's rasterizer
(as the JAX package of this repository states them), not from the port.

- `model`: the scene model (anchor quantization, the anchor hierarchy,
  the context model over the whole pool, the entropy models, the neural
  gaussians);
- `raster`: projection, binning and the tile blend, differentiated by
  autograd;
- `train`: the context phase's loss and Adam, and `follow`, the first
  steps of a resumed run;
- `serve`: a decoded scene's view;
- `codec`: the codec's quantization of a scene state.
"""
