from repro_torch.data.pipeline import (ShardedPipeline, SyntheticLMData,
                                       even_spans, make_pipeline)

__all__ = ["ShardedPipeline", "SyntheticLMData", "even_spans",
           "make_pipeline"]
