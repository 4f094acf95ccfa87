from .fri import Fri, FriConfig, FriProof, FriRound

__all__ = ["Fri", "FriConfig", "FriProof", "FriRound"]
