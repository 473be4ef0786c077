from .engine import (SUPPORTED_FAMILIES, Request, ServeEngine,
                     UnsupportedFamilyError)

__all__ = ["Request", "ServeEngine", "UnsupportedFamilyError",
           "SUPPORTED_FAMILIES"]
