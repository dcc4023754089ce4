from repro_torch.serving.batching import plan_microbatches  # noqa: F401
from repro_torch.serving.engine import (RenderEngine, ViewFuture,  # noqa: F401
                                        ViewResult)
