"""Model building blocks of the port (`repro.models` as far as the
transformer payload needs it)."""
