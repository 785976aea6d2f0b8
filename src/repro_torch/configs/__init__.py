"""Model configurations of the port (`repro.configs` as far as the port's
models need it)."""
