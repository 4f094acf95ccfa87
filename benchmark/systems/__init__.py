"""Systems under test, one module a kind of configuration (its
``system`` key)."""
