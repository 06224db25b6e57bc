"""The port's runtime: the train and serve step builders (``trainer``)
and fault tolerance (``fault``); the mesh rules and the pipeline runtime
come with later slices."""
