"""Moses core: features, the cost model, lottery-ticket adaptation and the
adaptive controller (port of `repro.core`)."""
