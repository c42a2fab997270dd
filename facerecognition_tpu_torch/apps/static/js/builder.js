// Database-builder page: launch a background build, poll
// /database-builder/status/<job_id> into a progress bar + log tail
// (reference templates/database_builder.html:844-882 interaction set).
(() => {
  const esc = (s) => String(s).replace(/[&<>"]/g,
    (c) => ({'&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;'}[c]));

  document.getElementById('builderform').addEventListener('submit', async (e) => {
    e.preventDefault();
    const fd = new FormData(e.target);
    const r = await fetch('/database-builder/build', {
      method: 'POST',
      body: new URLSearchParams(fd),
    });
    const j = await r.json();
    if (j.error) { alert(j.error); return; }
    document.getElementById('jobcard').style.display = 'block';
    let misses = 0;
    const poll = setInterval(async () => {
      let s;
      try {
        const r2 = await fetch('/database-builder/status/' + j.job_id);
        s = await r2.json();
        if (!r2.ok || s.error) throw new Error(s.error || r2.status);
        misses = 0;
      } catch (err) {
        // Transient network blips are retried; a job the server no longer
        // knows (restart wiped the in-memory registry) stops the poll.
        if (++misses >= 3) {
          clearInterval(poll);
          document.getElementById('jtitle').textContent =
            `build — status unavailable (${err.message})`;
        }
        return;
      }
      document.getElementById('jtitle').textContent =
        `${s.model_type} build — ${s.status}`;
      document.getElementById('bar').style.width = (s.progress ?? 0) + '%';
      document.getElementById('jmeta').textContent =
        `${(s.elapsed_seconds ?? 0).toFixed(1)} s elapsed`;
      document.getElementById('logs').textContent = (s.logs || []).join('\n');
      document.getElementById('files').innerHTML = (s.output_files || []).map(
        (p) => `<a href="/database-builder/download/${esc(p)}" download>` +
               `${esc(p)}</a>`).join(' ');
      if (s.status === 'completed' || s.status === 'failed') clearInterval(poll);
    }, 700);
  });
})();
