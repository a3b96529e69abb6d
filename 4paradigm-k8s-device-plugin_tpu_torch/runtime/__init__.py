"""The broker: one process per node owns the cards and runs tenant
programs under each tenant's HBM cap and compute share (``server``), and
the tenant's side of its wire (``client``, ``protocol``)."""
