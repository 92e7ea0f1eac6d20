"""repro_torch.serving — the deploy side of the train→deploy loop
(counterpart of ``repro.serving``).

  * ``export``  — ``Strategy.export(state) -> ServableModel``: the full
                  deployable model (split halves stitched at the cut),
                  round-trippable via ``save_servable``/``load_servable``
                  in the reference's file format.
  * ``scorer``  — ``BucketScorer``: one captured CUDA graph per padded
                  bucket (no capture in steady state) behind a
                  hot-swappable ``ModelSlot``.
  * ``batcher`` — ``RequestBatcher``/``ScreeningService``: a queue that
                  coalesces single-image requests into the largest ready
                  bucket under a max-wait, with backpressure, per-request
                  latency accounting, and ``obs`` trace lanes.
  * ``engine``  — LM serving: batched prefill, single-token decode (one
                  captured CUDA graph a model, ``captured_decode_step``)
                  and greedy generation, independent of the CNN service.
"""

from repro_torch.serving.batcher import (Backpressure, RequestBatcher,
                                         ScreeningService)
from repro_torch.serving.export import (ServableModel, load_servable,
                                        save_servable)
from repro_torch.serving.scorer import (DEFAULT_BUCKETS, PRECISIONS,
                                        BucketScorer, ModelSlot)

__all__ = ["ServableModel", "save_servable", "load_servable",
           "BucketScorer", "ModelSlot", "DEFAULT_BUCKETS", "PRECISIONS",
           "RequestBatcher", "ScreeningService", "Backpressure"]
