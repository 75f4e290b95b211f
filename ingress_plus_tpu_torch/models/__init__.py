"""Detection engine, confirm stage and the request->verdict pipeline."""
