from .model import (ModelBundle, bundle_for, input_specs, memory_estimate, model_flops,
                    param_count, synth_batch)

__all__ = ["ModelBundle", "bundle_for", "param_count", "memory_estimate", "input_specs",
           "synth_batch", "model_flops"]
