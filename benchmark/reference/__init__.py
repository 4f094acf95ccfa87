"""Plain references of what the timed paths produce, independent of the
program."""
