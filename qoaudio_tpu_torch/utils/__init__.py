"""Host<->device transfers and timing for the port."""
