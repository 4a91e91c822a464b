"""Host-side genome domain model: GTO JSON, locations, DNA translation,
roles and the PATRIC source (copies of the reference package's
``genome/`` modules, holding what the port uses)."""
