from .fibonacci import FibonacciClaim, Witness, fibonacci_air

__all__ = ["FibonacciClaim", "Witness", "fibonacci_air"]
