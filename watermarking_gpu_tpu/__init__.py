"""watermarking_gpu_tpu — a spread-spectrum watermarking framework in JAX.

JAX/XLA implementation, with one Pallas kernel through Triton for the GPU,
of the capabilities of the OpenCL
reference kar-dim/Watermarking-GPU: NVF and Prediction-Error perceptual masks,
PSNR-scaled additive embedding, correlation-based detection, image and video
pipelines, and a settings.ini-driven benchmark CLI.
"""

from .models import BatchedWatermark, MaskType, Watermark
from .ops import strength_factor
from .serving import DetectorService, EmbedderService, IdentifierService

__version__ = "0.4.0"

__all__ = ["BatchedWatermark", "DetectorService", "EmbedderService",
           "IdentifierService", "MaskType", "Watermark", "strength_factor",
           "__version__"]
