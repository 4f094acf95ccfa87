from .stark import Stark, StarkConfig, StarkProof

__all__ = ["Stark", "StarkConfig", "StarkProof"]
