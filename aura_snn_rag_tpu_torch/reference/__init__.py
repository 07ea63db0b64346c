"""Plain references of the port's models, in plain `torch` alone, which
the tests hold the port to and whose copies the benchmark's checks use
(`perfbench/reference/`)."""
