"""The mesh's sharding rules (``sharding``) and int8 gradient
compression with error feedback (``compression``); counterpart of
``repro/parallel``."""
from .sharding import (batch_partition_spec, cache_specs, input_specs_tree,
                       shardings_from_specs, zero1_specs)
from .compression import (compress_int8, decompress_int8,
                          error_feedback_compress)
