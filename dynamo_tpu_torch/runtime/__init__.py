"""Runtime pieces needed in-process: the cancellation `Context`."""
