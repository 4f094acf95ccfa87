"""The benchmark's own tests: CPU at small sizes, and the cells on the card (-m cuda)."""
