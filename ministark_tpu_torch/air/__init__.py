from .trace import Matrix, TraceTable, Constrains, Provable

__all__ = ["Matrix", "TraceTable", "Constrains", "Provable"]
