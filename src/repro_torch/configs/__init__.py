"""Architecture configurations of the language-model scaffolding, one
module a model (``CONFIG``), as ``repro.configs`` has them; ``registry``
maps ``--arch`` ids onto them."""
