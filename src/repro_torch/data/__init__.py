"""Data of the port: ``synthetic`` (the ODM data sets), ``streaming``,
``lm`` (synthetic LM token batches), ``stratified`` (stratified
data-parallel sharding)."""
