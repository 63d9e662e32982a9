"""The drivers of the cells, one per traffic `driver` name."""
