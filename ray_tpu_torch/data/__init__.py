"""Data: the device feed (`iterator.iter_device_batches`)."""
