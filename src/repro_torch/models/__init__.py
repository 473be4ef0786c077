from .model import ModelBundle, bundle_for, memory_estimate, param_count

__all__ = ["ModelBundle", "bundle_for", "param_count", "memory_estimate"]
