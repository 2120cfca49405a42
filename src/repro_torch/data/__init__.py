from .pipeline import SyntheticTokenPipeline, make_batch_specs
