"""Parameter layouts over a device mesh (counterpart of ``repro.sharding``)."""
