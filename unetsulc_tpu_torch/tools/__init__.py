"""Command-line tools of the port: the matrix-unit probe, cohort builders
(``select_subjects``), ``.hie`` colour files (``create_sulcal_root_colors``)
and the ``.arg`` -> ``.npz`` converter (``convert_graphs``)."""
