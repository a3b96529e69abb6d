"""The broker: one process per node owns the cards and runs tenant
programs under each tenant's HBM cap and compute share (``server``), and
the tenant's side of its wire (``client``, ``protocol``).  Its state
survives its death in a journal (``journal``, with ``replication``'s
fence); ``trace`` is its flight recorder and claim forensics, ``timers``
its keepers' one thread, ``faults`` its fault injection, ``degraded`` a
client's enforcement while the broker is gone."""
