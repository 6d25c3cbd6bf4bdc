"""Multi-device execution: the 1-D gene mesh (:mod:`.mesh`)."""
