"""The port's native host library: record parsing and batch packing (`loader`)."""
