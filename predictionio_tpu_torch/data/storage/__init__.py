"""Storage layer: event-log and metadata DAO contracts (``base``), the
MEMORY and SQLITE backends, and the ``PIO_STORAGE_*`` registry
(``registry.Storage``)."""
