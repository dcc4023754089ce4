from repro_torch.serving.batching import plan_microbatches  # noqa: F401
from repro_torch.serving.engine import (RenderEngine, ViewFuture,  # noqa: F401
                                        ViewResult, prepare_field)
from repro_torch.serving.store import SceneStore  # noqa: F401
from repro_torch.serving.finetune import FineTuneLoop  # noqa: F401
from repro_torch.serving.fleet import export_scene, load_scene  # noqa: F401
from repro_torch.serving.router import (FleetError, FleetFuture,  # noqa: F401
                                        FleetResult, FleetRouter, HashRing)
