"""The in-cluster Kubernetes API client: the pod lister of monitor mode
and of the legacy controller."""
